"""Twin of tests/test_serve_cluster.py over ``repro_torch``: the port's
continuous-batching serving lane (``serve/server.py`` and ``ServeChain``)
against the JAX package's.

Every reference case runs here.  The queue, admission and autoscaler
cases drive both packages' ``RequestQueue``, ``ClusterServer`` and
``AutoScaler`` through the same sequence and compare statuses, counts,
details and events; the output cases hold the port's outputs against
the JAX package's and the reference's single-host ``_ref_chain`` (rtol
1e-4, atol 1e-5; the chain case the reference's 1e-5 / 1e-5).  The
SlaveLost case SIGKILLs a tcp slave process in each package.  The
port's ``HeteroCluster`` and ``admit`` default to the card, so every
port cluster names ``torch:cpu`` for the master and ``numpy`` for its
slaves, the autoscaler's admits included.  Every wait has its own
deadline; every cluster shuts down in a ``finally``.
"""
import threading
import time

import numpy as np
import pytest

from _torch_cluster_parity import port_backends
from repro.core.backends import get_backend as jax_get_backend
from repro.core.cluster.scheduler import ServeChain as JaxServeChain
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro.serve import server as jax_server
from repro_torch.core.cluster.scheduler import ServeChain
from repro_torch.core.master_slave import HeteroCluster
from repro_torch.serve import server

SERVERS = (server, jax_server)


def _relu(y):
    return np.maximum(y, 0.0)


def _ref_chain(x, weights, between):
    """The reference's single-host chain: the JAX package's numpy conv
    and the between stages, for one (H, W, Cin) image or a batch."""
    nb = jax_get_backend("numpy")
    y = np.asarray(x, np.float32)
    single = y.ndim == 3
    if single:
        y = y[None]
    for w, f in zip(weights, between):
        y = nb.conv(y, w)
        if f is not None:
            y = f(y)
    return y[0] if single else y


def _weights(rng, chans):
    return [rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.1
            for cin, cout in zip(chans, chans[1:])]


def _clusters(slowdowns, **kw):
    """(the port's cluster, the JAX package's) with pinned probe times."""
    c = HeteroCluster(slowdowns, port_backends(len(slowdowns)), **kw)
    try:
        jc = JaxHeteroCluster(slowdowns, **kw)
    except BaseException:
        c.shutdown()
        raise
    c.probe_times = jc.probe_times = list(slowdowns)
    return c, jc


def _shutdown(*clusters):
    for c in clusters:
        c.shutdown()


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


class FakeClock:
    """Deterministic monotonic clock for queue/deadline/scaler tests."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _req(srv, rid, clock, deadline_s=None, steps=1):
    x = np.zeros((4, 4, 3), np.float32)
    deadline = None if deadline_s is None else clock() + deadline_s
    return srv._Request(rid, x, deadline, steps, 0, srv.ServeFuture(), clock())


def _ids(reqs):
    return [r.request_id for r in reqs]


# ---------------------------------------------------------------- chain


def test_serve_chain_matches_forward_chain():
    """The cross-batch pipeline reproduces the per-batch chain exactly,
    one push late and in order, in the port as in the JAX package."""
    rng = np.random.default_rng(0)
    weights = _weights(rng, [3, 8, 8])
    between = [_relu, _relu]
    batches = [rng.standard_normal((b, 8, 8, 3)).astype(np.float32)
               for b in (3, 1, 4, 2)]
    c, jc = _clusters([1.0, 1.0, 1.5], pipeline=True, microbatches=2)
    try:
        results = []
        for chain in (ServeChain(c, weights, between),
                      JaxServeChain(jc, weights, between)):
            outs = []
            for x in batches:
                y = chain.push(x)
                if y is not None:
                    outs.append(y)
            assert chain.in_flight
            outs.append(chain.flush())
            assert not chain.in_flight and chain.flush() is None
            assert len(outs) == len(batches)
            results.append(outs)
        for x, y, jy in zip(batches, *results):
            _close(y, _ref_chain(x, weights, between), rtol=1e-5, atol=1e-5)
            _close(y, jy, rtol=1e-5, atol=1e-5)
    finally:
        _shutdown(c, jc)


# ------------------------------------------------- queue and admission


def test_request_queue_expires_stale_heads_fake_clock():
    got = []
    for srv in SERVERS:
        clock = FakeClock()
        q = srv.RequestQueue(max_depth=8, clock=clock)
        assert q.offer(_req(srv, 0, clock, deadline_s=1.0))
        assert q.offer(_req(srv, 1, clock, deadline_s=None))
        assert q.offer(_req(srv, 2, clock, deadline_s=5.0))
        clock.advance(2.0)  # request 0 is now past deadline
        ready, expired = q.take(max_n=2)
        assert _ids(expired) == [0]
        assert _ids(ready) == [1, 2]
        assert len(q) == 0
        got.append((_ids(ready), _ids(expired)))
    assert got[0] == got[1]


def test_request_queue_culls_expired_behind_live_window():
    got = []
    for srv in SERVERS:
        clock = FakeClock()
        q = srv.RequestQueue(max_depth=8, clock=clock)
        assert q.offer(_req(srv, 0, clock))
        assert q.offer(_req(srv, 1, clock))
        assert q.offer(_req(srv, 2, clock, deadline_s=1.0))  # behind the window
        assert q.offer(_req(srv, 3, clock))
        clock.advance(2.0)
        ready, expired = q.take(max_n=2)
        assert _ids(ready) == [0, 1] and _ids(expired) == [2]
        assert len(q) == 1
        ready2, expired2 = q.take(max_n=2)
        assert _ids(ready2) == [3] and not expired2
        got.append([_ids(ready), _ids(expired), _ids(ready2), _ids(expired2)])
    assert got[0] == got[1]


def test_request_queue_close_refuses_late_offers():
    got = []
    for srv in SERVERS:
        clock = FakeClock()
        q = srv.RequestQueue(max_depth=8, clock=clock)
        assert q.offer(_req(srv, 0, clock))
        leftovers = q.close()
        assert _ids(leftovers) == [0]
        late = q.offer(_req(srv, 1, clock))
        assert q.closed and not late
        got.append((_ids(leftovers), q.closed, late))
    assert got[0] == got[1]


def test_request_queue_admission_control():
    got = []
    for srv in SERVERS:
        clock = FakeClock()
        q = srv.RequestQueue(max_depth=2, clock=clock)
        offers = [q.offer(_req(srv, i, clock)) for i in range(3)]
        assert offers == [True, True, False]  # full: admission-control reject
        ready, _ = q.take(max_n=10)
        again = q.offer(_req(srv, 3, clock))
        assert len(ready) == 2 and again
        got.append((offers, _ids(ready), again))
    assert got[0] == got[1]


def test_server_rejects_when_queue_full_and_expires_dead_requests():
    """Requests beyond max_queue resolve 'rejected' at once; one whose
    deadline passed resolves 'expired' uncomputed; the live one is ok
    and equals the JAX package's and the reference chain's output."""
    rng = np.random.default_rng(1)
    weights = _weights(rng, [3, 8])
    x = rng.standard_normal((6, 6, 3)).astype(np.float32)
    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl in ((server, c), (jax_server, jc)):
            s = srv.ClusterServer(cl, weights, max_batch=2, max_queue=2)
            f1 = s.submit(x)
            f2 = s.submit(x, deadline_s=-1.0)  # already past deadline
            f3 = s.submit(x)
            r3 = f3.result(timeout=1.0)
            assert r3.status == "rejected" and "queue full" in r3.detail
            with s:
                r1 = f1.result(timeout=30.0)
                r2 = f2.result(timeout=30.0)
            assert r1.status == "ok"
            assert r2.status == "expired" and r2.output is None
            st = s.stats()
            assert (st["completed"], st["rejected"], st["expired"]) == (1, 1, 1)
            got.append(([r.status for r in (r1, r2, r3)], r3.detail, r1.output,
                        {k: st[k] for k in ("completed", "rejected", "expired")}))
        (statuses, detail, out, counts), (jstatuses, jdetail, jout, jcounts) = got
        assert (statuses, detail, counts) == (jstatuses, jdetail, jcounts)
        _close(out, jout)
        _close(out, _ref_chain(x, weights, [None]))
    finally:
        _shutdown(c, jc)


def test_submit_validates_input():
    rng = np.random.default_rng(2)
    weights = _weights(rng, [3, 8])
    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        for srv, cl in ((server, c), (jax_server, jc)):
            s = srv.ClusterServer(cl, weights, max_batch=2)
            with pytest.raises(ValueError, match="H, W, Cin"):
                s.submit(np.zeros((2, 6, 6, 3), np.float32))
            with pytest.raises(ValueError, match="step_fn"):
                s.submit(np.zeros((6, 6, 3), np.float32), steps=3)
    finally:
        _shutdown(c, jc)


# --------------------------------------------------- continuous batching


def test_batch_join_between_steps_preserves_solo_numerics():
    """Multi-step requests re-enter between decode steps and join the
    next partial batch; every output equals a solo run and the JAX
    package's server."""
    rng = np.random.default_rng(3)
    weights = _weights(rng, [8, 8])
    between = [_relu]

    def step_fn(x, y, step):
        return 0.5 * y + 0.25 * x

    reqs = [(rng.standard_normal((6, 6, 8)).astype(np.float32), steps)
            for steps in (3, 1, 2, 3, 2)]

    def solo(x, steps):
        y = None
        for s in range(steps):
            y = _ref_chain(x, weights, between)
            if s + 1 < steps:
                x = step_fn(x, y, s + 1)
        return y

    c, jc = _clusters([1.0, 1.0, 1.5], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl in ((server, c), (jax_server, jc)):
            s = srv.ClusterServer(cl, weights, between=between, step_fn=step_fn,
                                  max_batch=3)
            with s:
                futs = [s.submit(x, steps=n) for x, n in reqs]
                resps = [f.result(timeout=60.0) for f in futs]
            assert [r.status for r in resps] == ["ok"] * len(reqs)
            assert [r.steps for r in resps] == [n for _, n in reqs]
            got.append(resps)
        for (x, n), r, jr in zip(reqs, *got):
            _close(r.output, solo(x, n))
            _close(r.output, jr.output)
    finally:
        _shutdown(c, jc)


def test_head_applied_per_finished_request():
    rng = np.random.default_rng(4)
    weights = _weights(rng, [3, 8])
    fc = rng.standard_normal((6 * 6 * 8, 5)).astype(np.float32)

    def head(z):
        return z.reshape(z.shape[0], -1) @ fc

    xs = [rng.standard_normal((6, 6, 3)).astype(np.float32) for _ in range(3)]
    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl in ((server, c), (jax_server, jc)):
            with srv.ClusterServer(cl, weights, head=head, max_batch=2) as s:
                got.append([f.result(timeout=30.0) for f in [s.submit(x) for x in xs]])
        for x, r, jr in zip(xs, *got):
            want = head(_ref_chain(x, weights, [None])[None])[0]
            _close(r.output, want)
            _close(r.output, jr.output)
    finally:
        _shutdown(c, jc)


def test_mixed_shape_requests_form_separate_slabs():
    rng = np.random.default_rng(7)
    weights = _weights(rng, [3, 8])
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((6, 6, 3), (8, 8, 3), (6, 6, 3), (8, 8, 3))]
    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl in ((server, c), (jax_server, jc)):
            s = srv.ClusterServer(cl, weights, max_batch=4)
            futs = [s.submit(x) for x in xs]  # one queue, two shapes
            with s:
                resps = [f.result(timeout=60.0) for f in futs]
            assert [r.status for r in resps] == ["ok"] * len(xs)
            got.append(resps)
        for x, r, jr in zip(xs, *got):
            _close(r.output, _ref_chain(x, weights, [None]))
            _close(r.output, jr.output)
    finally:
        _shutdown(c, jc)


def test_submit_after_stop_is_rejected_not_stranded():
    rng = np.random.default_rng(8)
    weights = _weights(rng, [3, 8])
    x = rng.standard_normal((6, 6, 3)).astype(np.float32)
    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl in ((server, c), (jax_server, jc)):
            s = srv.ClusterServer(cl, weights, max_batch=2)
            with s:
                assert s.submit(x).result(timeout=30.0).status == "ok"
            late = s.submit(x).result(timeout=1.0)  # must not hang
            assert late.status == "rejected" and late.detail == "server stopped"
            got.append((late.status, late.detail))
        assert got[0] == got[1]
    finally:
        _shutdown(c, jc)


# ------------------------------------------------------- fault handling


def test_slave_lost_mid_request_completes_on_survivors():
    """SIGKILL a tcp slave process mid-request in each package: every
    response 'ok', the loss a retry count, one failure recorded, and
    the outputs equal the reference chain's and each other's.  Each
    package's cluster lives alone (with two tcp clusters with heartbeats
    in one process, the kill in one leaves the other's first gather
    waiting, in either package)."""
    rng = np.random.default_rng(5)
    weights = _weights(rng, [3, 8, 8])
    xs = [rng.standard_normal((6, 6, 3)).astype(np.float32) for _ in range(6)]
    kw = dict(transport="tcp", pipeline=True, microbatches=2, heartbeat_s=2.0)
    got = []
    for srv, make in (
        (server, lambda: HeteroCluster([1.0, 1.0, 2.0], port_backends(3), **kw)),
        (jax_server, lambda: JaxHeteroCluster([1.0, 1.0, 2.0], **kw)),
    ):
        cl = make()
        try:
            cl.probe_times = [1.0, 1.0, 2.0]
            killed = threading.Event()
            victim = cl.procs[-1]

            def kill_after_layer0(y, victim=victim, killed=killed):
                if not killed.is_set():
                    killed.set()
                    victim.kill()
                return _relu(y)

            with srv.ClusterServer(cl, weights, between=[kill_after_layer0, _relu],
                                   max_batch=2) as s:
                resps = [f.result(timeout=120.0) for f in [s.submit(x) for x in xs]]
            assert [r.status for r in resps] == ["ok"] * len(xs)
            assert len(cl.failures) == 1 and victim.returncode is not None
            assert sum(r.retries for r in resps) >= 1
            got.append(resps)
        finally:
            cl.shutdown()
    for x, r, jr in zip(xs, *got):
        _close(r.output, _ref_chain(x, weights, [_relu, _relu]))
        _close(r.output, jr.output)


def test_head_exception_fails_inflight_and_poisons_server():
    rng = np.random.default_rng(9)
    weights = _weights(rng, [3, 8])
    x = rng.standard_normal((6, 6, 3)).astype(np.float32)

    def bad_head(z):
        raise RuntimeError("head blew up")

    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl in ((server, c), (jax_server, jc)):
            s = srv.ClusterServer(cl, weights, head=bad_head, max_batch=1)
            futs = [s.submit(x) for _ in range(4)]
            with s:
                resps = [f.result(timeout=30.0) for f in futs]
            statuses = [r.status for r in resps]
            assert "error" in statuses and set(statuses) <= {"error", "rejected"}
            assert all("RuntimeError" in r.detail for r in resps if r.status == "error")
            late = s.submit(x).result(timeout=1.0)
            assert late.status == "rejected"
            assert late.detail == "server stopped on error"
            got.append((set(statuses), late.detail))
        assert got[0] == got[1]
    finally:
        _shutdown(c, jc)


# ------------------------------------------------------------ autoscaler


class FakeCluster:
    """Membership-only cluster stand-in for scaler unit tests."""

    def __init__(self, n=1):
        self.slave_ids = list(range(1, n + 1))
        self.calls = []
        self._next = n + 1

    @property
    def n_slaves(self):
        return len(self.slave_ids)

    def admit(self, **kw):
        dev = self._next
        self._next += 1
        self.slave_ids.append(dev)
        self.calls.append(("admit", dev, kw))
        return dev

    def evict(self, device):
        self.slave_ids.remove(device)
        self.calls.append(("evict", device))


def test_autoscaler_thresholds_and_cooldown_fake_clock():
    got = []
    for srv in SERVERS:
        clock = FakeClock()
        fc = FakeCluster(n=1)
        scaler = srv.AutoScaler(
            fc, scale_up_depth=4, scale_down_depth=0, min_slaves=1,
            max_slaves=3, cooldown_s=2.0, clock=clock,
            admit_kwargs={"backend": "numpy"},
        )
        actions = [scaler.observe(3), scaler.observe(4), scaler.observe(9)]
        clock.advance(2.0)
        actions.append(scaler.observe(9))
        clock.advance(2.0)
        actions.append(scaler.observe(9))
        assert fc.n_slaves == 3
        actions += [scaler.observe(0), scaler.observe(0)]
        clock.advance(2.0)
        actions.append(scaler.observe(0))
        clock.advance(2.0)
        actions.append(scaler.observe(0))
        assert actions == [None, "admit", None, "admit", None, "evict", None,
                           "evict", None]
        assert fc.calls == [("admit", 2, {"backend": "numpy"}),
                            ("admit", 3, {"backend": "numpy"}),
                            ("evict", 3), ("evict", 2)]
        got.append((actions, fc.calls, scaler.events))
    assert got[0] == got[1]


def test_autoscaler_drives_real_admit_evict_from_load():
    """A burst queued before start() makes the serve loop admit a
    ``numpy`` slave; the drained queue evicts back to min; every
    response 'ok' and equal to the reference chain's, in both
    packages."""
    rng = np.random.default_rng(6)
    weights = _weights(rng, [3, 8])
    xs = [rng.standard_normal((6, 6, 3)).astype(np.float32) for _ in range(8)]
    c, jc = _clusters([1.0, 1.0], pipeline=True, microbatches=2)
    try:
        got = []
        for srv, cl, admit_kw in ((server, c, {"backend": "numpy"}),
                                  (jax_server, jc, None)):
            scaler = srv.AutoScaler(
                cl, scale_up_depth=6, scale_down_depth=0, min_slaves=1,
                max_slaves=2, cooldown_s=0.0, admit_kwargs=admit_kw,
            )
            s = srv.ClusterServer(cl, weights, max_batch=2, max_queue=16,
                                  autoscaler=scaler)
            futs = [s.submit(x) for x in xs]
            with s:
                resps = [f.result(timeout=60.0) for f in futs]
                deadline = time.monotonic() + 30.0
                while cl.n_slaves > 1 and time.monotonic() < deadline:
                    time.sleep(0.01)  # idle loop iterations evict to min
            assert [r.status for r in resps] == ["ok"] * len(futs)
            actions = [e[1] for e in scaler.events]
            assert "admit" in actions and "evict" in actions
            assert cl.n_slaves == 1
            got.append(resps)
        assert c.backends[-1] == "numpy"  # what the admitted slave ran
        for x, r, jr in zip(xs, *got):
            _close(r.output, _ref_chain(x, weights, [None]))
            _close(r.output, jr.output)
    finally:
        _shutdown(c, jc)
