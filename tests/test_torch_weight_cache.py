"""Twin of tests/test_weight_cache.py over ``repro_torch``: the versioned
weight-broadcast cache (``codec.WeightRef``, ``HeteroCluster.
_weight_version`` and the per-link shipped-token bookkeeping), its
slave-side resolution, and the byte collapse on repeated train steps
and serve pushes with static weights.

Each reference case runs here.  Where the reference counts bytes, the
port's count equals the JAX package's cluster's on the same inputs
(the canonical accounting is transport- and package-independent), and
the gradients of every counted step match the JAX package's and the
single-device VJP (rtol 1e-4, atol 1e-3).  Port clusters name their
backends (``torch:cpu`` master, ``numpy`` slaves).
"""
import numpy as np
import pytest

from _torch_cluster_parity import assert_matches, grads
from repro.core.cluster.scheduler import ServeChain as JaxServeChain
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro_torch.core.cluster.codec import WeightRef
from repro_torch.core.cluster.scheduler import ServeChain
from repro_torch.core.master_slave import HeteroCluster


def _weights(rng):
    w1 = rng.normal(size=(3, 3, 3, 6)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 6, 8)).astype(np.float32)
    return w1, w2


def _cluster(n=2, **kw):
    c = HeteroCluster([1.0] * n, ["torch:cpu"] + ["numpy"] * (n - 1), **kw)
    c.probe_times = [1.0] * n
    return c


def _jax_cluster(n=2, **kw):
    c = JaxHeteroCluster([1.0] * n, **kw)
    c.probe_times = [1.0] * n
    return c


# ---------------------------------------------------------------------------
# master-side version store
# ---------------------------------------------------------------------------


def test_weight_version_bumps_only_on_new_array_object():
    c, jc = _cluster(), _jax_cluster()
    try:
        w = np.ones((3, 3, 3, 4), np.float32)
        w2 = w + 0.0
        for cl in (c, jc):
            assert cl._weight_version("k", w) == (0, False)
            assert cl._weight_version("k", w) == (0, True)  # same object: cached
            assert cl._weight_version("k", w2) == (1, False)  # new object
            assert cl._weight_version("other", w) == (0, False)  # per-key spaces
    finally:
        c.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# end-to-end: repeated train steps collapse the weight broadcast
# ---------------------------------------------------------------------------


def _train_bytes(c, x, ws, steps):
    """(comm_bytes, gradients) of each of ``steps`` identical
    train-chain calls."""
    out = []
    for _ in range(steps):
        c.reset_stats()
        res = c.conv_train_chain(x, list(ws), [None, None], lambda z, i: (None, z))
        out.append((c.comm_bytes, grads(res)))
    return out


def _both_train_bytes(x, ws, steps, n=2, **kw):
    """The port's per-step bytes, each step's gradients held against the
    JAX package's, whose per-step bytes must be the same numbers."""
    c, jc = _cluster(n, **kw), _jax_cluster(n, **kw)
    try:
        ours, theirs = _train_bytes(c, x, ws, steps), _train_bytes(jc, x, ws, steps)
    finally:
        c.shutdown()
        jc.shutdown()
    for (b, g), (jb, jg) in zip(ours, theirs):
        assert b == jb
        assert_matches(g, jg)
    return [b for b, _ in ours]


def test_train_chain_second_step_ships_tokens_not_kernels():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    ws = _weights(rng)
    b1, b2, b3 = _both_train_bytes(x, ws, 3)
    wire_kernel_bytes = sum(w.nbytes for w in ws)
    assert b2 < b1
    assert b1 - b2 > 0.25 * wire_kernel_bytes  # shards became tokens
    assert b3 == b2  # steady state


def test_weight_cache_off_reships_every_step():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    ws = _weights(rng)
    b1, b2 = _both_train_bytes(x, ws, 2, weight_cache=False)
    assert b1 == b2


def test_new_weight_object_and_new_geometry_invalidate_token():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    w1, w2 = _weights(rng)
    x2 = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    seen = []
    for c in (_cluster(), _jax_cluster()):
        try:
            (_, _), (steady, _) = _train_bytes(c, x, (w1, w2), 2)
            # an optimizer step produces NEW arrays: the version bumps and
            # the fresh kernels ship again
            c.reset_stats()
            c.conv_train_chain(
                x, [w1 * 0.9, w2 * 0.9], [None, None], lambda z, i: (None, z)
            )
            new_object = c.comm_bytes
            assert new_object > steady
            # same weights, different batch geometry: counts change, so
            # the shard boundaries may move — the token must not match
            _train_bytes(c, x, (w1, w2), 1)  # re-prime with the originals
            c.reset_stats()
            c.conv_train_chain(
                x2, [w1, w2], [None, None], lambda z, i: (None, z)
            )
            assert c.comm_bytes > steady
            seen.append((steady, new_object, c.comm_bytes))
        finally:
            c.shutdown()
    assert seen[0] == seen[1]  # the port's bytes are the JAX package's


def test_evict_drops_per_link_shipped_state():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    ws = _weights(rng)
    c = _cluster(3)
    try:
        _train_bytes(c, x, ws, 1)
        assert len(c._wshipped) == 2  # one token map per live slave link
        c.evict(c.slave_ids[0])
        assert len(c._wshipped) == 1
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# slave-side cache resolution
# ---------------------------------------------------------------------------


def test_weight_ref_miss_raises_slave_error_not_garbage():
    """A token for a (key, version) the slave never cached is a master
    bug: it must surface as a loud SlaveError, not a silent wrong
    answer."""
    c = _cluster()
    try:
        x = np.zeros((1, 4, 4, 2), np.float32)
        c.sockets[0].write_to_slave(
            ("conv", (x, WeightRef("never-shipped", 0, None)))
        )
        with pytest.raises(RuntimeError, match="slave device 1 failed"):
            c._check_result(c.sockets[0].read_on_master())
    finally:
        c.shutdown()


def test_weight_ref_version_mismatch_raises():
    c = _cluster()
    try:
        x = np.zeros((1, 4, 4, 2), np.float32)
        w = np.ones((1, 1, 2, 3), np.float32)
        c.sockets[0].write_to_slave(("conv", (x, WeightRef("k", 0, w))))
        out = c._check_result(c.sockets[0].read_on_master())
        assert out.shape == (1, 4, 4, 3)
        np.testing.assert_array_equal(out, np.full((1, 4, 4, 3), 0.0, np.float32))
        # cached hit: the token alone reproduces the same result
        c.sockets[0].write_to_slave(("conv", (x, WeightRef("k", 0, None))))
        np.testing.assert_array_equal(
            c._check_result(c.sockets[0].read_on_master()), out
        )
        # stale version: the slave must refuse, not silently reuse
        c.sockets[0].write_to_slave(("conv", (x, WeightRef("k", 1, None))))
        with pytest.raises(RuntimeError, match="slave device 1 failed"):
            c._check_result(c.sockets[0].read_on_master())
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# the serve lane: push-to-push weight bytes collapse
# ---------------------------------------------------------------------------


def _steady_push_bytes(c, chain, x):
    """Wire bytes of one STEADY-STATE push: the pipeline keeps a batch
    in flight, so push N's window includes push N-1's tail gather —
    warm two pushes first, then measure the third."""
    chain.push(x)
    chain.push(x)
    c.reset_stats()
    chain.push(x)
    return c.comm_bytes


def test_serve_push_weight_bytes_collapse_to_tokens():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    ws = _weights(rng)
    got = {}
    for name, make, chain_cls in (("port", _cluster, ServeChain),
                                  ("jax", _jax_cluster, JaxServeChain)):
        c_on = make()
        c_off = make(weight_cache=False)
        try:
            got[name] = (_steady_push_bytes(c_on, chain_cls(c_on, list(ws)), x),
                         _steady_push_bytes(c_off, chain_cls(c_off, list(ws)), x))
        finally:
            c_on.shutdown()
            c_off.shutdown()
    on, off = got["port"]
    assert on < off  # static serve weights ride as ~24-byte tokens
    assert got["port"] == got["jax"]
