"""The program's own spans and counters, kept in memory while a torch
profiler records.

A span is one piece of work at a layer boundary: its name, its start and
end in ns on the clock the profiler stamps its host events with, the
thread that ran it, the span that encloses it on that thread (its
parent) and the index of the ``step`` span that encloses it in time (the
steps run on the master's thread).  A counter keeps, per span name, how
many spans there were, their summed seconds and the bytes they moved,
by operand where a boundary names its operands, and the seconds by each
label a boundary gives (``backend``, ``op``, ...).

Recording follows the profiler: a boundary records only while
``torch.autograd.profiler._is_profiler_enabled`` is set, which
``torch.profiler.profile`` sets for every thread while it records.  So
an operator who runs the trainer under ``torch.profiler`` gets the spans
of the traced window and nothing else, and a process that has not
loaded torch never records.  Off the profiler a boundary costs one
module lookup and one attribute read: no clock read, nothing kept.

The spans are not profiler ranges: the profiler mirrors a host range
that holds kernel launches onto the card's timeline, where it would read
as device work.  They are taken from the ``time.perf_counter()`` reads
the boundaries already take and shifted onto ``time.time_ns()``, the
clock of the profiler's host events, by an offset taken when a session
starts.

A session begins with the first span recorded after a boundary passed
without recording: the spans and counters are cleared and the offset is
taken anew.  ``spans()`` and ``counters()`` read the session in progress
or the last one ended, and leave it as it is.  The spans are kept in a
deque of ``CAP`` (the oldest dropped); the counters count every span.

In-process slaves record into the master's process.  Slave processes
(tcp, shm) record into their own, where nothing reads them yet.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

CAP = 65_536
_PROFILER = "torch.autograd.profiler"


class Span(NamedTuple):
    """One recorded span, as ``spans()`` returns it."""

    name: str
    start_ns: int
    end_ns: int
    thread: int             # the OS thread id (threading.get_native_id)
    parent: Optional[int]   # index in ``spans()`` of the enclosing span
    step: Optional[int]     # index in the session of the enclosing step
    attrs: dict


@dataclasses.dataclass
class Counter:
    """The session's totals for one span name."""

    count: int = 0
    s: float = 0.0
    bytes: int = 0
    bytes_by: Dict[str, int] = dataclasses.field(default_factory=dict)
    s_by: Dict[tuple, float] = dataclasses.field(default_factory=dict)  # (label, value)


class _Session:
    def __init__(self):
        self.lock = threading.Lock()
        self.live = False
        self.offset_ns = 0
        self.kept: collections.deque = collections.deque(maxlen=CAP)
        self.counters: Dict[str, Counter] = {}

    def add(self, name, t0, t1, nbytes, attrs) -> None:
        thread = threading.get_native_id()
        with self.lock:
            if not self.live:
                self.live = True
                self.kept.clear()
                self.counters = {}
                self.offset_ns = time.time_ns() - time.perf_counter_ns()
            self.kept.append((name, self.offset_ns + round(t0 * 1e9),
                              self.offset_ns + round(t1 * 1e9), thread, attrs))
            c = self.counters.setdefault(name, Counter())
            c.count += 1
            c.s += t1 - t0
            if isinstance(nbytes, dict):
                for op, n in nbytes.items():
                    c.bytes_by[op] = c.bytes_by.get(op, 0) + n
                    c.bytes += n
            elif nbytes:
                c.bytes += nbytes
            for label in attrs.items():
                c.s_by[label] = c.s_by.get(label, 0.0) + (t1 - t0)


_SESSION = _Session()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records now; a boundary passed while it
    does not ends the session."""
    on = getattr(sys.modules.get(_PROFILER), "_is_profiler_enabled", False)
    if not on:
        _SESSION.live = False
    return on


def record(name: str, t0: float, t1: float, nbytes=None, **attrs) -> None:
    """The span ``name`` from ``t0`` to ``t1`` (``time.perf_counter()``
    reads the caller took), while a profiler records.  ``nbytes``: the
    bytes it moved, an int or a dict by operand; ``attrs``: labels.
    Where building the arguments costs, guard the call by
    ``recording()``."""
    if recording():
        _SESSION.add(name, t0, t1, nbytes, attrs)


class _Timed:
    def __init__(self, name, nbytes, attrs):
        self.name, self.nbytes, self.attrs = name, nbytes, attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record(self.name, self.t0, time.perf_counter(), self.nbytes, **self.attrs)
        return False


def span(name: str, nbytes=None, **attrs):
    """A context manager that records the span ``name`` around its body,
    for a boundary that takes no clock reads of its own; one shared null
    context while no profiler records."""
    return _Timed(name, nbytes, attrs) if recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (no span, no time), while a
    profiler records."""
    if recording():
        with _SESSION.lock:
            if _SESSION.live:
                _SESSION.counters.setdefault(name, Counter()).count += n


def counters() -> Dict[str, Counter]:
    """A copy of the session's counters by name."""
    with _SESSION.lock:
        return {k: dataclasses.replace(c, bytes_by=dict(c.bytes_by), s_by=dict(c.s_by))
                for k, c in _SESSION.counters.items()}


def spans() -> List[Span]:
    """The session's kept spans in the order they were recorded, each
    with its parent (the innermost span of its thread whose interval
    holds it) and its step (the ``step`` span whose interval holds its
    start, numbered from the session's first step)."""
    with _SESSION.lock:
        kept = list(_SESSION.kept)
        n_steps = _SESSION.counters.get("step", Counter()).count
    parents: List[Optional[int]] = [None] * len(kept)
    by_thread = collections.defaultdict(list)
    for i, (_, t0, t1, thread, _) in enumerate(kept):
        by_thread[thread].append((t0, -t1, i))
    for marks in by_thread.values():
        stack: List[int] = []  # the open spans of the thread, outermost first
        for t0, neg_t1, i in sorted(marks):
            while stack and not (kept[stack[-1]][1] <= t0 and -neg_t1 <= kept[stack[-1]][2]):
                stack.pop()
            parents[i] = stack[-1] if stack else None
            stack.append(i)
    steps = sorted((t0, t1) for name, t0, t1, _, _ in kept if name == "step")
    first = n_steps - len(steps)  # steps dropped from the deque's front
    starts = [s[0] for s in steps]
    out = []
    for i, (name, t0, t1, thread, attrs) in enumerate(kept):
        j = bisect.bisect_right(starts, t0) - 1
        step = first + j if j >= 0 and t0 <= steps[j][1] else None
        out.append(Span(name, t0, t1, thread, parents[i], step, attrs))
    return out
