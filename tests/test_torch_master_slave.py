"""Twin of tests/test_master_slave.py over ``repro_torch``: Algorithms 1
& 2, the distributed convolution, must match the local reference,
forward AND backward, including heterogeneous (uneven) kernel
allocations — and match the JAX package's cluster on the same inputs.

Every case of the reference runs here.  The port's cluster names its
backends (its default is the card): a ``torch:cpu`` master and slave
(the plain PyTorch conv and its autograd VJP) and a ``numpy`` slave; the
JAX package's cluster keeps its ``numpy`` default.  The end-to-end CNN
case starts both packages from the JAX package's ``init_cnn(key(0))``
carried over with ``convert.params_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cluster_parity import clusters, ref_conv
from repro.core.master_slave import _np_probe as jax_np_probe
from repro.models.cnn import cnn_loss as jax_cnn_loss
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.models.cnn import make_cnn_config as jax_make_cnn_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.master_slave import _np_probe, make_distributed_conv
from repro_torch.models.cnn import cnn_loss, make_cnn_config

SLOWDOWNS = [1.0, 1.5, 2.0]  # master + 2 slaves, heterogeneous
SLAVES = ["torch:cpu", "numpy"]


@pytest.fixture(scope="module")
def both():
    port, ref = clusters(SLOWDOWNS, slaves=SLAVES)
    kw = dict(image_size=16, in_channels=3, kernel_size=5, num_kernels=16, batch=4)
    port.probe(**kw)
    ref.probe(**kw)
    yield port, ref
    port.shutdown()
    ref.shutdown()


def test_probe_reports_slowdowns(both):
    """One positive probe time per device in both packages; the
    slowdown mechanism's base measurement is positive.  (As in the
    reference, wall-clock ordering between emulated devices is not
    asserted: on a contended host it does not hold.)"""
    for c in both:
        t = c.probe_times
        assert len(t) == 3 and all(x > 0 for x in t)
    kw = dict(image_size=8, in_channels=3, kernel_size=3, num_kernels=4, batch=2,
              repeats=1, slowdown=1.0)
    assert _np_probe(**kw) > 0
    assert jax_np_probe(**kw) > 0


def test_forward_matches_reference(both):
    port, ref = both
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=(5, 5, 3, 21)).astype(np.float32)  # odd count: uneven shards
    got = port.conv_forward(x, w)
    want = ref_conv(x, w)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref.conv_forward(x, w), atol=1e-5)


def test_backward_matches_reference(both):
    port, ref = both
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=(5, 5, 3, 21)).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, 21)).astype(np.float32)

    def f(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
        )

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx_want, dw_want = vjp(jnp.asarray(g))
    dx, dw = port.conv_backward(x, w, g)
    dx_ref, dw_ref = ref.conv_backward(x, w, g)
    np.testing.assert_allclose(dx, np.asarray(dx_want), atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_want), atol=1e-4)
    np.testing.assert_allclose(dx, dx_ref, atol=1e-4)
    np.testing.assert_allclose(dw, dw_ref, atol=1e-4)


def test_end_to_end_cnn_gradients(both):
    """Full CNN loss + grads through the port's distributed conv == the
    JAX package's local loss and grads, on its params and inputs."""
    port, _ = both
    jcfg = jax_make_cnn_config(6, 10)
    jparams = jax_init_cnn(jax.random.key(0), jcfg)
    jimgs = jax.random.normal(jax.random.key(1), (4, 32, 32, 3))
    jlabels = jnp.array([0, 1, 2, 3])
    loss_ref, _ = jax_cnn_loss(jparams, jimgs, jlabels, cfg=jcfg)
    g_ref = jax.grad(lambda p: jax_cnn_loss(p, jimgs, jlabels, cfg=jcfg)[0])(jparams)

    cfg = make_cnn_config(6, 10)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = {(l, n): t.requires_grad_() for l, d in params.items() for n, t in d.items()}
    imgs = torch.from_numpy(np.array(jimgs))
    labels = torch.from_numpy(np.array(jlabels))
    loss_dist, _ = cnn_loss(params, imgs, labels, cfg=cfg,
                            conv_fn=make_distributed_conv(port))
    assert np.isclose(float(loss_ref), float(loss_dist.detach()), atol=1e-5)
    grads = torch.autograd.grad(loss_dist, list(leaves.values()))
    for (l, n), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref[l][n]), atol=1e-4)


def test_uneven_allocation_used(both):
    """Heterogeneous probe times must produce non-uniform kernel shares,
    the JAX package's for the same times (deterministic: shares from
    pinned times, not wall-clock)."""
    port, ref = both
    saved = [c.probe_times for c in both]
    try:
        for c in both:
            c.probe_times = [1.0, 1.5, 2.0]
        counts = port.shares_for(100)
        assert counts.sum() == 100
        assert counts[0] > counts[1] > counts[2]
        assert counts.tolist() == ref.shares_for(100).tolist()
    finally:
        port.probe_times, ref.probe_times = saved
