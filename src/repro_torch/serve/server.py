"""Continuous-batching request server over an elastic ``HeteroCluster``.

The paper distributes the conv layers because they dominate processing
time — the same argument holds at inference, so this lane routes
conv-heavy forward passes through the cluster's pipelined
scatter/gather hot path instead of training steps:

    submit() -> RequestQueue -> [serve loop] -> ServeChain -> cluster
                   |                 |
              admission control   slot-based dynamic batching,
              + deadlines         cross-batch scatter/gather overlap,
                                  AutoScaler admit()/evict()

One background thread owns the cluster.  Each loop iteration packs up
to ``max_batch`` waiting requests into a slab (prefill packing),
pushes it into a ``ServeChain`` — which returns the PREVIOUS slab's
output while the new slab's layer-0 scatter is already on the wire —
and completes futures.  Multi-step requests re-enter the ready set
between steps, so they join whatever partially-filled batch forms
next (continuous batching, JetStream-style prefill/decode separation:
fresh requests are packed alongside continuing ones).

A ``SlaveLost`` mid-request is NOT an error: the cluster's ``Pending``
recovery drains the batch on the survivors and the master recomputes
the dead slave's shard; the server surfaces it as ``retries`` on the
affected responses.  A ``SlaveError`` (a slave's backend raised) IS an
error — and so is any exception out of a user ``head``/``step_fn``:
the pipeline state is unrecoverable, so the server fails every
in-flight request with ``"error"``, rejects what is still queued, and
stops.  Once the loop has exited (error or ``stop()``), the queue is
closed atomically, so a late ``submit`` resolves ``"rejected"``
instead of stranding a future no thread will ever read.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# statuses a ServeResponse can carry
STATUS_OK = "ok"
STATUS_REJECTED = "rejected"   # admission control: queue full / server stopped
STATUS_EXPIRED = "expired"     # deadline passed while queued
STATUS_ERROR = "error"         # unrecoverable failure (SlaveError, bad stage)


@dataclasses.dataclass
class ServeResponse:
    """The terminal outcome of one submitted request.

    Attributes:
        request_id: server-assigned id, unique per ``ClusterServer``.
        status: one of ``"ok" | "rejected" | "expired" | "error"``.
        output: the chain output for this request (head applied when
            the server has one); None unless status is ``"ok"``.
        retries: slave losses absorbed while this request was in
            flight — the survivor-recompute count, not an error count.
        steps: decode steps actually completed.
        queued_s: submit -> first batch admission wall time.
        latency_s: submit -> completion wall time.
        detail: human-readable reason for non-ok statuses.
    """

    request_id: int
    status: str
    output: Optional[np.ndarray] = None
    retries: int = 0
    steps: int = 0
    queued_s: float = 0.0
    latency_s: float = 0.0
    detail: str = ""


class ServeFuture:
    """Handle returned by ``ClusterServer.submit``; resolves exactly once."""

    def __init__(self):
        self._event = threading.Event()
        self._response: Optional[ServeResponse] = None

    def done(self) -> bool:
        """Whether the response is available (never blocks)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResponse:
        """Block until the response is available and return it.

        Args:
            timeout: max seconds to wait (None = forever).

        Raises:
            TimeoutError: the response did not arrive within ``timeout``.
        """
        if not self._event.wait(timeout):
            raise TimeoutError("serve request still in flight")
        assert self._response is not None
        return self._response

    def _resolve(self, response: ServeResponse) -> None:
        self._response = response
        self._event.set()


@dataclasses.dataclass
class _Request:
    """Internal queue entry; ``x`` is mutated between decode steps."""

    request_id: int
    x: np.ndarray                 # next input to run, (H, W, Cin)
    deadline: Optional[float]     # absolute clock value, None = no deadline
    steps_left: int
    steps_done: int
    future: ServeFuture
    t_submit: float
    t_admitted: Optional[float] = None
    retries: int = 0


class RequestQueue:
    """Thread-safe bounded FIFO with admission control and deadline culling.

    ``offer`` refuses beyond ``max_depth`` (the admission-control
    backpressure signal); ``take`` pops up to ``max_n`` ready requests
    and separately returns the ones whose deadline passed while they
    waited, so the serve loop can expire them without computing.

    Args:
        max_depth: admission-control bound on queued requests.
        clock: monotonic-seconds source (injectable for tests).
    """

    def __init__(self, max_depth: int, clock: Callable[[], float] = time.monotonic):
        self.max_depth = int(max_depth)
        self.clock = clock
        self._items: deque = deque()
        self._closed = False
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)

    def __len__(self) -> int:
        """Current queue depth (thread-safe)."""
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        """Whether ``close()`` ran — all further offers are refused."""
        with self._lock:
            return self._closed

    def offer(self, req: "_Request") -> bool:
        """Enqueue unless full or closed.  Returns False when
        admission-control rejects (depth already at ``max_depth``) or
        the queue was closed by shutdown."""
        with self._lock:
            if self._closed or len(self._items) >= self.max_depth:
                return False
            self._items.append(req)
            self._nonempty.notify()
            return True

    def take(self, max_n: int, now: Optional[float] = None
             ) -> Tuple[List["_Request"], List["_Request"]]:
        """Pop up to ``max_n`` live requests in FIFO order.

        Args:
            max_n: slot budget — at most this many ready requests.
            now: clock value for deadline checks (defaults to ``clock()``).

        Returns:
            ``(ready, expired)`` — the whole queue is scanned, so
            expired entries are culled wherever they sit (not just
            ahead of the live window), never count against ``max_n``,
            and a stale head never blocks live traffic behind it.
        """
        if now is None:
            now = self.clock()
        ready: List[_Request] = []
        expired: List[_Request] = []
        with self._lock:
            keep: deque = deque()
            while self._items:
                req = self._items.popleft()
                if req.deadline is not None and now >= req.deadline:
                    expired.append(req)
                elif len(ready) < max_n:
                    ready.append(req)
                else:
                    keep.append(req)
            self._items = keep
            return ready, expired

    def close(self) -> List["_Request"]:
        """Mark the queue closed and pop everything still queued, in
        one critical section (shutdown path).

        Closing under the same lock as ``offer`` means no request can
        slip in between the final drain and the close and be silently
        stranded: after this returns, every ``offer`` fails.
        """
        with self._lock:
            self._closed = True
            items = list(self._items)
            self._items.clear()
            return items

    def wait_nonempty(self, timeout: float) -> bool:
        """Block until the queue is non-empty or ``timeout`` elapses."""
        with self._lock:
            if self._items:
                return True
            # reprolint: allow=blocking-under-lock -- Condition.wait RELEASES the lock while blocked; holding it here is the condition-variable protocol, not a stall
            return self._nonempty.wait(timeout)


class AutoScaler:
    """Load-driven ``admit()``/``evict()`` from queue-depth signals.

    The serve loop calls ``observe(queue_depth)`` once per iteration;
    the scaler admits a slave when the backlog crosses
    ``scale_up_depth`` and evicts the youngest when it falls to
    ``scale_down_depth``, bounded by ``[min_slaves, max_slaves]`` and
    rate-limited by ``cooldown_s`` (both directions share the
    cooldown, so a burst cannot thrash admit/evict pairs).

    Args:
        cluster: the elastic ``HeteroCluster`` to scale.
        scale_up_depth: admit when ``queue_depth >= scale_up_depth``.
        scale_down_depth: evict when ``queue_depth <= scale_down_depth``.
        min_slaves: never evict below this many slaves.
        max_slaves: never admit above this many slaves.
        cooldown_s: minimum seconds between scaling actions.
        clock: monotonic-seconds source (injectable for tests).
        admit_kwargs: forwarded to ``cluster.admit`` (backend,
            slowdown, bandwidth_mbps, ...).
    """

    def __init__(self, cluster, *, scale_up_depth: int = 8,
                 scale_down_depth: int = 0, min_slaves: int = 1,
                 max_slaves: int = 4, cooldown_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 admit_kwargs: Optional[dict] = None):
        assert scale_down_depth < scale_up_depth
        self.cluster = cluster
        self.scale_up_depth = scale_up_depth
        self.scale_down_depth = scale_down_depth
        self.min_slaves = min_slaves
        self.max_slaves = max_slaves
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.admit_kwargs = dict(admit_kwargs or {})
        self.events: List[Tuple[float, str, int]] = []  # (t, action, device)
        self._t_last: Optional[float] = None

    def observe(self, queue_depth: int) -> Optional[str]:
        """Feed one load sample; maybe scale.

        Args:
            queue_depth: current backlog (queued + ready requests).

        Returns:
            ``"admit"`` or ``"evict"`` when an action was taken this
            call, else None (in cooldown, in bounds, or no signal).
        """
        now = self.clock()
        if self._t_last is not None and now - self._t_last < self.cooldown_s:
            return None
        n = self.cluster.n_slaves
        if queue_depth >= self.scale_up_depth and n < self.max_slaves:
            device = self.cluster.admit(**self.admit_kwargs)
            self.events.append((now, "admit", device))
            self._t_last = now
            return "admit"
        if queue_depth <= self.scale_down_depth and n > self.min_slaves:
            device = self.cluster.slave_ids[-1]  # youngest first
            self.cluster.evict(device)
            self.events.append((now, "evict", device))
            self._t_last = now
            return "evict"
        return None


@dataclasses.dataclass
class _BatchRec:
    """One in-flight slab: its requests + the failure-count watermark.

    ``failures_mark`` is ``len(cluster.failures)`` taken right AFTER
    this slab's own push returned; completion reads the count again
    after the push/flush that drains the slab.  Consecutive slabs'
    windows are therefore disjoint — a loss is attributed to exactly
    one slab, never double-counted."""

    reqs: List[_Request]
    failures_mark: int
    t_formed: float


class ClusterServer:
    """Continuous-batching server: requests in, ``ServeChain`` slabs out.

    Lifecycle: construct -> ``submit()`` any time -> ``start()`` spins
    up the serve loop -> ``stop()`` drains in-flight work and rejects
    what is still queued.  Usable as a context manager.

    Args:
        cluster: the ``HeteroCluster`` to route forward passes through.
        layer_weights: conv kernel per distributed layer.
        between: master-only stage after each layer (``ServeChain``
            semantics; the final between runs before the head).
        head: optional master-only epilogue applied to each completed
            slab, ``head(z) -> out`` with the batch axis preserved —
            per-request outputs are ``out[i]``.  Only finished requests
            see the head; intermediate decode steps feed ``step_fn``.
        step_fn: for multi-step requests, ``step_fn(x, y, step) ->
            next_x`` maps a request's previous input and its chain
            output slice to the next step's input (None = requests must
            be single-step).
        max_batch: slot count — at most this many requests per slab.
        max_queue: admission-control bound (see ``RequestQueue``).
        default_deadline_s: deadline applied when ``submit`` gives none
            (None = no deadline).
        autoscaler: optional ``AutoScaler`` consulted every iteration.
        clock: monotonic-seconds source (injectable for tests).
    """

    def __init__(self, cluster, layer_weights: Sequence[np.ndarray], *,
                 between: Optional[Sequence[Optional[Callable]]] = None,
                 head: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 step_fn: Optional[Callable] = None,
                 max_batch: int = 8, max_queue: int = 64,
                 default_deadline_s: Optional[float] = None,
                 autoscaler: Optional[AutoScaler] = None,
                 clock: Callable[[], float] = time.monotonic):
        from repro_torch.core.cluster.scheduler import ServeChain

        assert max_batch >= 1
        self.cluster = cluster
        self.head = head
        self.step_fn = step_fn
        self.max_batch = int(max_batch)
        self.default_deadline_s = default_deadline_s
        self.autoscaler = autoscaler
        self._clock = clock
        self._chain = ServeChain(cluster, layer_weights, between)
        self._queue = RequestQueue(max_queue, clock)
        self._ready: List[_Request] = []   # continuing multi-step requests
        self._lock = threading.Lock()
        self._next_id = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        # stats (loop thread writes, stats() reads under the lock)
        self._completed = 0
        self._rejected = 0
        self._expired = 0
        self._scaler_failures = 0
        self._scaler_last_error: Optional[str] = None
        self._latencies: deque = deque(maxlen=512)
        self._t_first_done: Optional[float] = None
        self._t_last_done: Optional[float] = None

    # ---- client side -------------------------------------------------

    def submit(self, x: np.ndarray, *, deadline_s: Optional[float] = None,
               steps: int = 1) -> ServeFuture:
        """Enqueue one request.

        Args:
            x: a single input image ``(H, W, Cin)`` (no batch axis —
                the server packs the batch).
            deadline_s: seconds from now after which the request is
                expired instead of computed (defaults to the server's
                ``default_deadline_s``; None = no deadline).
            steps: decode steps to run; > 1 requires ``step_fn``.

        Returns:
            A ``ServeFuture``; admission-control rejections resolve it
            immediately with status ``"rejected"``.

        Raises:
            ValueError: bad input rank or ``steps`` without a
                ``step_fn``.
        """
        x = np.asarray(x, np.float32)
        if x.ndim != 3:
            raise ValueError(f"expected one (H, W, Cin) image, got shape {x.shape}")
        if steps < 1 or (steps > 1 and self.step_fn is None):
            raise ValueError("steps > 1 requires a step_fn")
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else now + deadline_s
        fut = ServeFuture()
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        req = _Request(rid, x, deadline, steps, 0, fut, now)
        if self._fatal is not None or not self._queue.offer(req):
            if self._fatal is not None:
                detail = "server stopped on error"
            elif self._queue.closed:
                detail = "server stopped"
            else:
                detail = f"queue full (max_queue={self._queue.max_depth})"
            with self._lock:
                self._rejected += 1
            fut._resolve(ServeResponse(rid, STATUS_REJECTED, detail=detail))
        return fut

    def stats(self) -> dict:
        """Snapshot of serving counters.

        Returns:
            dict with ``completed/rejected/expired`` counts, queue
            depth, ``p50_ms``/``p99_ms`` over the last completions,
            ``throughput_rps`` across the completion window, and
            ``scaler_failures``/``scaler_last_error`` — autoscaler
            ``observe()`` exceptions the loop absorbed.
        """
        with self._lock:
            lat = np.array(self._latencies, np.float64)
            out = {
                "completed": self._completed,
                "rejected": self._rejected,
                "expired": self._expired,
                "queue_depth": len(self._queue) + len(self._ready),
                "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else None,
                "scaler_failures": self._scaler_failures,
                "scaler_last_error": self._scaler_last_error,
            }
            span = ((self._t_last_done or 0.0) - (self._t_first_done or 0.0))
            out["throughput_rps"] = (
                self._completed / span if self._completed > 1 and span > 0 else None
            )
            return out

    # ---- lifecycle ---------------------------------------------------

    def start(self) -> "ClusterServer":
        """Start the serve loop thread; idempotent.  Returns self."""
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cluster-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain: finish queued + in-flight requests, then stop the loop.
        Safe to call twice; no-op if never started."""
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ClusterServer":
        """Context manager: ``start()`` on entry."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Context manager: ``stop()`` on exit."""
        self.stop()

    # ---- serve loop --------------------------------------------------

    def _form_batch(self, now: float) -> List[_Request]:
        """Pack up to ``max_batch`` requests: continuing decode-step
        requests first (they already hold pipeline state), then fresh
        prefill requests from the queue — expiring stale entries from
        both sources without computing them.

        A slab is one ``np.stack``, so every request in it must share
        a shape: the oldest candidate's shape wins this slab, and
        differently-shaped candidates wait at the front of the ready
        set for the next slab (shapes alternate, nobody starves)."""
        batch: List[_Request] = []
        still_ready: List[_Request] = []
        for req in self._ready:
            if req.deadline is not None and now >= req.deadline:
                self._expire(req, now)
            elif len(batch) < self.max_batch:
                batch.append(req)
            else:
                still_ready.append(req)
        self._ready = still_ready
        fresh, expired = self._queue.take(self.max_batch - len(batch), now)
        for req in expired:
            self._expire(req, now)
        batch.extend(fresh)
        if batch:
            shape = batch[0].x.shape
            deferred = [r for r in batch if r.x.shape != shape]
            if deferred:
                batch = [r for r in batch if r.x.shape == shape]
                self._ready = deferred + self._ready
        for req in batch:
            if req.t_admitted is None:
                req.t_admitted = now
        return batch

    def _expire(self, req: _Request, now: float) -> None:
        with self._lock:
            self._expired += 1
        req.future._resolve(ServeResponse(
            req.request_id, STATUS_EXPIRED, steps=req.steps_done,
            queued_s=now - req.t_submit, latency_s=now - req.t_submit,
            detail="deadline passed before compute",
        ))

    def _complete(self, rec: _BatchRec, out: np.ndarray,
                  failures_end: int) -> None:
        """Resolve a finished slab: slave losses during its flight
        (``failures_end`` is the failure count snapshotted right after
        the push/flush that drained it) become per-request retry
        counts; finishing requests get the head applied, continuing
        ones step and rejoin the ready set."""
        now = self._clock()
        retries = failures_end - rec.failures_mark
        finishing = [i for i, r in enumerate(rec.reqs) if r.steps_left == 1]
        z = self.head(out) if (self.head is not None and finishing) else out
        for i, req in enumerate(rec.reqs):
            req.retries += retries
            req.steps_done += 1
            req.steps_left -= 1
            if req.steps_left > 0:
                req.x = np.asarray(
                    self.step_fn(req.x, out[i], req.steps_done), np.float32
                )
                self._ready.append(req)
                continue
            with self._lock:
                self._completed += 1
                self._latencies.append(now - req.t_submit)
                if self._t_first_done is None:
                    self._t_first_done = now
                self._t_last_done = now
            req.future._resolve(ServeResponse(
                req.request_id, STATUS_OK, output=np.asarray(z[i]),
                retries=req.retries, steps=req.steps_done,
                queued_s=(req.t_admitted or now) - req.t_submit,
                latency_s=now - req.t_submit,
            ))

    def _fail(self, recs: Sequence[_BatchRec], err: BaseException) -> None:
        """Unrecoverable pipeline failure: resolve every affected
        request with ``"error"`` and poison the server."""
        self._fatal = err
        for rec in recs:
            for req in rec.reqs:
                if not req.future.done():
                    req.future._resolve(ServeResponse(
                        req.request_id, STATUS_ERROR, steps=req.steps_done,
                        detail=f"{type(err).__name__}: {err}",
                    ))

    def _reject_leftovers(self) -> None:
        """Close the queue (late submits now bounce atomically) and
        reject everything still unserved."""
        for req in self._queue.close() + self._ready:
            if not req.future.done():
                with self._lock:
                    self._rejected += 1
                req.future._resolve(ServeResponse(
                    req.request_id, STATUS_REJECTED, steps=req.steps_done,
                    detail="server stopped",
                ))
        self._ready = []

    def _loop(self) -> None:
        # slabs whose futures may still be unresolved, oldest first;
        # the catch-all below fails them on ANY escape (SlaveError,
        # a user head/step_fn raising in _complete, ...) so no future
        # is ever stranded by the loop thread dying
        inflight: List[_BatchRec] = []
        try:
            while True:
                now = self._clock()
                if self.autoscaler is not None:
                    try:
                        self.autoscaler.observe(
                            len(self._queue) + len(self._ready))
                    except Exception as e:
                        # a failed admit() must not take the loop down,
                        # but it must not vanish either: surface it in
                        # stats() so operators see a scaler that can't
                        # scale
                        with self._lock:
                            self._scaler_failures += 1
                            self._scaler_last_error = repr(e)
                batch = self._form_batch(now)
                if batch:
                    rec = _BatchRec(batch, 0, now)
                    inflight.append(rec)
                    x = np.stack([r.x for r in batch], axis=0)
                    prev_out = self._chain.push(x)
                    # the slab's retry window opens here, after its own
                    # push: the previous slab owns everything earlier
                    rec.failures_mark = len(self.cluster.failures)
                    if prev_out is not None:
                        self._complete(inflight[0], prev_out,
                                       rec.failures_mark)
                        inflight.pop(0)
                elif inflight:
                    # nothing waiting: drain the in-flight slab rather
                    # than hold its latency hostage to the next arrival
                    out = self._chain.flush()
                    mark = len(self.cluster.failures)
                    self._complete(inflight[0], out, mark)
                    inflight.pop(0)
                elif not self._running:
                    break
                else:
                    self._queue.wait_nonempty(0.005)
        except BaseException as err:
            self._fail(inflight, err)
        finally:
            self._reject_leftovers()
