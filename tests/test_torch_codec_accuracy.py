"""Twin of tests/test_codec_accuracy.py over ``repro_torch``: accuracy
against bytes for the lossy codec stages on the reference's CIFAR-shaped
work, through the port's ``HeteroCluster.conv_train_chain``.

Each case holds the reference's own bounds on the port (int8: dW within
1e-2 and dx within 5e-2 of the fp32 wire, more than 3.5x fewer bytes;
top-k with error feedback: a loss drop above 0.7x fp32's, fewer bytes),
and the port's gradients, losses and byte counts against the JAX
package's run on the same inputs (rtol 1e-4, atol 1e-3, the transport
twins'; bytes equal).  Every device is ``numpy`` in both packages, so
what differs is the port's cluster, scheduler, transport and codec.
"""
import numpy as np

from _torch_cluster_parity import ATOL, RTOL, assert_matches
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro_torch.core.master_slave import HeteroCluster

_CIFAR = (8, 32, 32, 3)


def _data(rng):
    """The reference's inputs: uniform(-1, 1) images, kernels at a 0.3
    init scale."""
    x = rng.uniform(-1.0, 1.0, size=_CIFAR).astype(np.float32)
    w1 = (0.3 * rng.uniform(-1.0, 1.0, size=(3, 3, 3, 8))).astype(np.float32)
    w2 = (0.3 * rng.uniform(-1.0, 1.0, size=(3, 3, 8, 12))).astype(np.float32)
    return x, w1, w2


def _relu():
    def between(y):
        mask = (y > 0).astype(np.float32)
        return np.maximum(y, 0.0), lambda gz: gz * mask

    return between


def _train_step(c, x, w1, w2):
    """One fwd+bwd of the 2-layer chain under loss 0.5*||y||^2;
    returns (res, comm_bytes)."""
    c.reset_stats()
    res = c.conv_train_chain(
        x, [w1, w2], [_relu(), None], lambda z, i: (None, z)
    )
    return res, c.comm_bytes


def _make(wire_codec=None, jax=False):
    if jax:
        c = JaxHeteroCluster([1.0, 1.0], wire_codec=wire_codec)
    else:
        c = HeteroCluster([1.0, 1.0], ["numpy", "numpy"], wire_codec=wire_codec)
    c.probe_times = [1.0, 1.0]
    return c


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _grads(res):
    return (res.dx, res.dw[0], res.dw[1])


def test_int8_train_step_grads_within_1e2_at_4x_fewer_bytes():
    rng = np.random.default_rng(0)
    x, w1, w2 = _data(rng)
    clusters = [_make(), _make("int8"), _make(jax=True), _make("int8", jax=True)]
    try:
        (ref, bytes32), (got, bytes8), (jref, jbytes32), (jgot, jbytes8) = (
            _train_step(c, x, w1, w2) for c in clusters
        )
        # the reference's acceptance bound on the port
        assert _rel(got.dw[0], ref.dw[0]) <= 1e-2
        assert _rel(got.dw[1], ref.dw[1]) <= 1e-2
        assert _rel(got.dx, ref.dx) <= 5e-2
        assert bytes32 / bytes8 > 3.5
        # and the port's run against the JAX package's, wire for wire
        assert_matches(_grads(ref), _grads(jref))
        assert_matches(_grads(got), _grads(jgot))
        assert (bytes32, bytes8) == (jbytes32, jbytes8)
    finally:
        for c in clusters:
            c.shutdown()


def _sgd_losses(c, x, w1, w2, steps=8, lr=2.0):
    """The reference's 8 SGD steps on 0.5*mean(y^2), the loss computed
    master-side in fp32; returns (losses, total bytes, final kernels)."""
    losses, total_bytes = [], 0
    for _ in range(steps):
        got = {}

        def head(z, i):
            z = np.asarray(z, np.float32)
            got.setdefault("y", []).append(z)
            return None, z / z.size

        c.reset_stats()
        res = c.conv_train_chain(x, [w1, w2], [_relu(), None], head)
        total_bytes += c.comm_bytes
        y = np.concatenate(got["y"], axis=0)
        losses.append(0.5 * float(np.mean(y * y)))
        w1 = w1 - lr * res.dw[0]
        w2 = w2 - lr * res.dw[1]
    return losses, total_bytes, (w1, w2)


def test_topk_grads_converge_like_fp32_with_fewer_bytes():
    rng = np.random.default_rng(1)
    x, w1, w2 = _data(rng)
    clusters = [_make(), _make("grads=topk:0.05"),
                _make(jax=True), _make("grads=topk:0.05", jax=True)]
    try:
        (ref_losses, ref_bytes, ref_w), (tk_losses, tk_bytes, tk_w), \
            (jref_losses, jref_bytes, jref_w), (jtk_losses, jtk_bytes, jtk_w) = (
                _sgd_losses(c, x, w1, w2) for c in clusters
            )
    finally:
        for c in clusters:
            c.shutdown()

    # the reference's bounds on the port
    assert ref_losses[-1] < ref_losses[0]
    assert tk_losses[-1] < tk_losses[0]
    ref_drop = ref_losses[0] - ref_losses[-1]
    tk_drop = tk_losses[0] - tk_losses[-1]
    assert tk_drop > 0.7 * ref_drop
    assert tk_bytes < ref_bytes
    # the port's trajectories against the JAX package's
    np.testing.assert_allclose(ref_losses, jref_losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tk_losses, jtk_losses, rtol=RTOL, atol=ATOL)
    assert_matches(ref_w, jref_w)
    assert_matches(tk_w, jtk_w)
    assert (ref_bytes, tk_bytes) == (jref_bytes, jtk_bytes)
