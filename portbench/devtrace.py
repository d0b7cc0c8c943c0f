"""What a traced run's profiler saw on the card.

Read from the profiler's raw kineto records, as ``chip_smoke.py::
device_trace`` does (a frozen copy of its busy-share arithmetic: the
device's kernels, copies and sets, overlaps counted once), extended
with what the benchmark's per-layer metrics read:

* the traced window, from the ``pb.window`` range;
* host<->card copy time (``Memcpy HtoD`` / ``DtoH`` records);
* each ``pb.cuda.*`` range's kernel time: a kernel belongs to the range
  that its launch (the runtime call with the kernel's correlation id)
  lies in (one thread at a time is inside a backend call; the torch
  thread id of a range and CUPTI's of a launch differ off the main
  thread, so the host clock decides); where the trace holds no launch
  for a kernel, to the range whose host interval holds the kernel's
  device interval.  Never by kernel name.  ``attributed`` counts both
  ways, ``unattributed_ops`` names what neither placed;
* the breakdown: the device operations that took most time, and the
  idle time by what the host's threads were doing (their innermost
  ``pb.*`` range at each gap's midpoint).

Ranges the profiler mirrors onto the card's timeline (``pb.*``) are no
device work and are left out.
"""
from __future__ import annotations

import bisect
import collections

GAP_LABELS = {
    "pb.step": "master_stages",
    "pb.gather": "gather_wait",
    "pb.scatter": "scatter",
    "pb.cpu_shard": "cpu_shard",
    "pb.cuda.conv": "cuda_call",
    "pb.cuda.conv_vjp": "cuda_call",
    "pb.serve.push": "serve_chain",
}
COPY_PREFIXES = ("Memcpy HtoD", "Memcpy DtoH")


class _Ranges:
    """One thread's ``pb.*`` ranges (nested, as a thread's ranges are),
    as a timeline of the innermost open range, for point queries."""

    def __init__(self, spans):
        # closes before opens at one time; of ranges opening together the
        # outer (longer) first, of ranges closing together the inner first
        marks = sorted([(t0, 1, -t1, name) for t0, t1, name in spans]
                       + [(t1, 0, -t0, name) for t0, t1, name in spans])
        stack, self.times, self.names = [], [], []
        for t, opening, _, name in marks:
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            self.times.append(t)
            self.names.append(stack[-1] if stack else None)

    def innermost(self, t, prefix="pb."):
        """The innermost range open at ``t`` if its name has ``prefix``."""
        i = bisect.bisect_right(self.times, t) - 1
        name = self.names[i] if i >= 0 else None
        return name if name is not None and name.startswith(prefix) else None


def _merge(intervals):
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def summarize(prof, top: int = 10) -> dict:
    """The card's activity in the ``pb.window`` range of ``prof``'s
    trace; times in seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, launches, threads = [], {}, collections.defaultdict(list)
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith("pb."):
                device.append((t0, t1, name, e.correlation_id()))
        elif name == "pb.window":
            window = (t0, t1)
        elif name.startswith("pb."):
            threads[e.start_thread_id()].append((t0, t1, name))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (e.start_thread_id(), t0)
    if window is None:
        raise RuntimeError("the trace holds no pb.window range")
    w0, w1 = window
    ranges = {tid: _Ranges(s) for tid, s in threads.items()}
    cuda_spans = sorted(s for spans in threads.values() for s in spans
                        if s[2].startswith("pb.cuda."))
    cuda_starts = [s[0] for s in cuda_spans]

    def cuda_range(t0, t1=None):
        """The ``pb.cuda.*`` range whose host interval holds [t0, t1]."""
        i = bisect.bisect_right(cuda_starts, t0) - 1
        if i >= 0 and cuda_spans[i][0] <= t0 and (t1 or t0) <= cuda_spans[i][1]:
            return cuda_spans[i][2]
        return None

    inside = [d for d in device if d[0] >= w0 and d[1] <= w1]
    kernel_s = collections.Counter()
    attributed = collections.Counter()
    unattributed = collections.Counter()
    ops = collections.Counter()
    copy_s = 0.0
    for k0, k1, name, corr in inside:
        dur = (k1 - k0) / 1e9
        ops[name] += dur
        if name.startswith("Mem"):
            if name.startswith(COPY_PREFIXES):
                copy_s += dur
            continue
        launch = launches.get(corr) if corr else None
        if launch is not None:
            owner = cuda_range(launch[1])
            attributed["correlation" if owner else "launch_outside_ranges"] += 1
        else:
            owner = cuda_range(k0, k1)
            attributed["time" if owner else "unattributed"] += 1
            if not owner:
                unattributed[name[:80]] += 1
        if owner:
            kernel_s[owner] += dur
    busy = _merge((max(d[0], w0), min(d[1], w1)) for d in device
                  if d[1] > w0 and d[0] < w1)
    busy_s = sum(t1 - t0 for t0, t1 in busy) / 1e9
    idle = collections.Counter()
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        names = {GAP_LABELS.get(n, n) for n in
                 (r.innermost(mid) for r in ranges.values()) if n}
        idle["+".join(sorted(names)) or "outside_ranges"] += (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "copy_s": copy_s,
        "kernel_s": dict(kernel_s),
        "attributed": dict(attributed),
        "unattributed_ops": unattributed.most_common(3),
        "device_events": len(inside),
        "breakdown": {
            "device_ops": [[n, s] for n, s in ops.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)],
        },
    }
