"""Twin of tests/test_pipeline.py over ``repro_torch``: the asynchronous
pipelined protocol — double-buffered microbatch scatter/gather, the
layer chain, bandwidth-limited links and the FIFO ordering contract —
against the local reference and the JAX package's cluster.

Every reference case runs here.  The same seeded numpy inputs go
through the port's pipelined ``HeteroCluster`` (master ``torch:cpu``,
slaves ``numpy``) and the JAX package's; each result is held against
the single-device reference at the reference case's tolerance (atol
1e-4) and against the other package's.  The CNN case carries the JAX
package's initial params into the port (``convert.params_from_numpy``)
and holds the port's ``cnn_loss`` through ``make_distributed_conv`` —
a ``torch.autograd.Function`` over the cluster — to the JAX package's
loss and ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cluster_parity import clusters, ref_conv
from repro.core.master_slave import make_distributed_conv as jax_make_distributed_conv
from repro.models.cnn import cnn_loss as jax_cnn_loss
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.models.cnn import make_cnn_config as jax_make_cnn_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.master_slave import make_distributed_conv
from repro_torch.models.cnn import cnn_loss, make_cnn_config


@pytest.fixture(scope="module")
def pipelined():
    """Both packages' pipelined clusters; batch 5 over 3 microbatches
    exercises uneven microbatch sizes on top of uneven kernel shards."""
    c, jc = clusters([1.0, 1.5, 2.0], pipeline=True, microbatches=3)
    try:
        for cl in (c, jc):
            cl.probe(image_size=8, in_channels=3, kernel_size=5, num_kernels=8, batch=2)
        yield c, jc
    finally:
        c.shutdown()
        jc.shutdown()


def _data(b=5, s=8, cin=3, cout=21, k=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    g = rng.normal(size=(b, s, s, cout)).astype(np.float32)
    return x, w, g


def _vjp_ref(x, w, g):
    _, pullback = jax.vjp(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    return tuple(np.asarray(a) for a in pullback(jnp.asarray(g)))


def _close(got, jgot, want, atol=1e-4):
    """The port's and the JAX package's results against the reference
    and each other."""
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(jgot, want, atol=atol)
    np.testing.assert_allclose(got, jgot, atol=atol)


def test_pipelined_forward_matches_reference(pipelined):
    x, w, _ = _data()
    _close(*(cl.conv_forward(x, w) for cl in pipelined), ref_conv(x, w))


def test_pipelined_backward_matches_reference(pipelined):
    x, w, g = _data(seed=1)
    (dx, dw), (jdx, jdw) = (cl.conv_backward(x, w, g) for cl in pipelined)
    dx_want, dw_want = _vjp_ref(x, w, g)
    _close(dx, jdx, dx_want)
    _close(dw, jdw, dw_want)


def test_single_image_degenerates_to_barrier(pipelined):
    """batch < microbatches: no empty microbatches, same numerics."""
    x, w, _ = _data(b=1, seed=2)
    _close(*(cl.conv_forward(x, w) for cl in pipelined), ref_conv(x, w))


def test_forward_chain_matches_sequential(pipelined):
    """2-layer conv chain with master-only between stages == running the
    layers sequentially on the reference."""
    x, w1, _ = _data(cout=6, seed=3)
    rng = np.random.default_rng(4)
    w2 = rng.normal(size=(5, 5, 6, 9)).astype(np.float32)

    def between(y):
        return np.maximum(y, 0.0)[:, ::2, ::2, :]

    got = [cl.conv_forward_chain(x, [w1, w2], [between, None]) for cl in pipelined]
    _close(*got, ref_conv(between(ref_conv(x, w1)), w2))


def test_overlap_is_accounted(pipelined):
    x, w, _ = _data(seed=5)
    for cl in pipelined:
        cl.reset_stats()
        cl.conv_forward(x, w)
        t = cl.timing
        assert t.overlap_s > 0.0          # scatters were in flight during gathers
        assert t.gather_wait_s >= 0.0
        assert t.comm_s > 0.0


def test_gather_order_is_enforced(pipelined):
    """The FIFO sockets make out-of-order gathers a protocol violation."""
    x, w, _ = _data(b=2, seed=6)
    for cl in pipelined:
        p1 = cl.scatter_conv(x, w)
        p2 = cl.scatter_conv(x, w)
        with pytest.raises(RuntimeError):
            cl.gather_conv(p2)
        # the failed gather read nothing: draining in order still works
        np.testing.assert_allclose(cl.gather_conv(p1), ref_conv(x, w), atol=1e-4)
        np.testing.assert_allclose(cl.gather_conv(p2), ref_conv(x, w), atol=1e-4)


def test_bandwidth_limited_links_preserve_numerics():
    """Finite emulated links delay delivery, never corrupt it; the
    accounted bytes equal the JAX package's."""
    c, jc = clusters([1.0, 1.0], pipeline=True, microbatches=2, bandwidth_mbps=2000.0)
    try:
        x, w, g = _data(b=4, seed=7)
        got = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0]
            got.append((cl.conv_forward(x, w), *cl.conv_backward(x, w, g)))
            assert cl.comm_bytes > 0
        assert c.comm_bytes == jc.comm_bytes
        for a, b, want in zip(*got, (ref_conv(x, w), *_vjp_ref(x, w, g))):
            _close(a, b, want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_pipelined_weight_traffic_sent_once():
    """Pipelined microbatches send each layer's kernel shard ONCE; later
    microbatches carry w=None and the slave reuses its cached shard."""
    c, jc = clusters([1.0, 1.0], pipeline=True, microbatches=4)
    try:
        x, w, _ = _data(b=8, seed=8)
        sent = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0]
            cl.reset_stats()
            np.testing.assert_allclose(cl.conv_forward(x, w), ref_conv(x, w), atol=1e-4)
            shard_bytes = cl._split(w, cl.shares_for(w.shape[-1]))[1].nbytes
            to_slave = cl.sockets[0].bytes_to_slave
            # all 4 microbatch inputs + ONE shard (+ a few 8-byte flags);
            # resending the shard per microbatch would add 3*shard_bytes
            assert to_slave < x.nbytes + 2 * shard_bytes
            assert to_slave >= x.nbytes + shard_bytes
            sent.append(to_slave)
        assert sent[0] == sent[1]
    finally:
        c.shutdown()
        jc.shutdown()


def _named(tree, prefix=""):
    """``{"conv1.kernel": leaf, ...}`` of a nested dict of params."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_pipelined_end_to_end_cnn_gradients(pipelined):
    """The full CNN through the pipelined cluster == local: the port's
    ``cnn_loss`` through ``make_distributed_conv`` against the JAX
    package's loss and ``jax.grad`` from the same params and images
    (loss atol 1e-5, gradients atol 1e-4), and the JAX package's own
    distributed run against its local one."""
    c, jc = pipelined
    jcfg = jax_make_cnn_config(6, 10)
    jparams = jax_init_cnn(jax.random.key(0), jcfg)
    jimgs = jax.random.normal(jax.random.key(1), (4, 32, 32, 3))
    jlabels = jnp.array([0, 1, 2, 3])

    def jloss(p, conv_fn=None):
        kw = {} if conv_fn is None else {"conv_fn": conv_fn}
        return jax_cnn_loss(p, jimgs, jlabels, cfg=jcfg, **kw)[0]

    jdist = jax_make_distributed_conv(jc)
    loss_ref = float(jloss(jparams))
    assert np.isclose(loss_ref, float(jloss(jparams, jdist)), atol=1e-5)
    g_ref = _named(jax.grad(jloss)(jparams))
    g_jdist = _named(jax.grad(lambda p: jloss(p, jdist))(jparams))

    cfg = make_cnn_config(6, 10)
    params = params_from_numpy(jax.tree.map(np.array, jparams), "cpu")
    leaves = _named(params)
    for t in leaves.values():
        t.requires_grad_()
    imgs = torch.from_numpy(np.array(jimgs))
    labels = torch.from_numpy(np.array(jlabels)).long()
    loss, _ = cnn_loss(params, imgs, labels, cfg=cfg, conv_fn=make_distributed_conv(c))
    assert np.isclose(float(loss.detach()), loss_ref, atol=1e-5)
    g_port = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert g_port.keys() == g_ref.keys()
    for name, want in g_ref.items():
        np.testing.assert_allclose(np.asarray(g_jdist[name]), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(g_port[name].numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=name)
