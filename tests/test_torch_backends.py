"""Twin of tests/test_backends.py over ``repro_torch``: every registered
compute backend of the port produces the same conv / conv_vjp results as
the JAX package's reference conv and its ``numpy`` backend, and a
mixed-backend HeteroCluster matches the single-device reference model
end to end — the probe, the slaves, and the master time the same code
they run.

Every case of the reference runs here with its parametrisation.  The
port's backend names replace ``xla`` and ``pallas``: ``torch:cpu`` (the
plain PyTorch conv and its autograd VJP) and ``cuda`` (the hand-written
kernels, numpy in and out).  Without a card the ``cuda`` cases run the
``cuda`` backend's own ``conv``/``conv_vjp`` on CPU tensors, where each
kernel wrapper runs its plain version, and the ``cuda`` conv function
(``conv_fn_for_backend("cuda")``, ``Conv2dFunction``) likewise.

The reference's two sleep-timed ``sim`` probe cases fail under a loaded
host.  Their twins hold what does not depend on the host: the ``sim``
backend's nominal seconds (FLOPs over its rate) equal the JAX package's,
the probe's scaling is exact on a clock that only the ``sim`` sleeps
advance, and the measured ordering holds on the minimum of a few real
probes (a sleep only oversleeps).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jax_backends
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro.layers.conv import apply_conv as jax_apply_conv
from repro.models.cnn import cnn_loss as jax_cnn_loss
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.models.cnn import make_cnn_config as jax_make_cnn_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import backends
from repro_torch.core.backends import (
    CudaBackend,
    available_backends,
    get_backend,
    probe_conv_time,
)
from repro_torch.core.master_slave import HeteroCluster, make_distributed_conv
from repro_torch.models.cnn import cnn_loss, conv_fn_for_backend, make_cnn_config

PARITY_BACKENDS = ["numpy", "torch:cpu", "cuda"]
# the port's conv_fn of each backend: the one-device cluster's distributed
# conv over numpy, the plain conv, the kernels' Function
CONV_FNS = ["numpy", "torch", "cuda"]
# probe workloads of the sim cases: ~2.5 / 10 ms at 4 / 1 GFLOP/s, ~5 ms at 1
CLUSTER_PROBE = dict(image_size=16, in_channels=3, kernel_size=5, num_kernels=32, batch=8)
SIM_PROBE = dict(image_size=16, in_channels=3, kernel_size=5, num_kernels=16, batch=8)
REAL_PROBES = 3


def _backend(name):
    """The port's backend of ``name``; ``cuda`` on a host without a card
    is the ``cuda`` backend's code over CPU tensors (each kernel wrapper's
    plain version)."""
    if name == "cuda" and not torch.cuda.is_available():
        b = object.__new__(CudaBackend)
        b.device = torch.device("cpu")
        return b
    return get_backend(name)


def _ref_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    )


def _data(b=2, s=8, cin=3, cout=7, k=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    g = rng.normal(size=(b, s, s, cout)).astype(np.float32)
    return x, w, g


def _nominal_s(pkg, name, kw):
    """The ``sim`` backend's nominal seconds for one conv of a probe
    workload: its FLOPs over its rate."""
    sim = pkg.get_backend(name)
    x = np.zeros((kw["batch"], kw["image_size"], kw["image_size"], kw["in_channels"]),
                 np.float32)
    w = np.zeros((kw["kernel_size"], kw["kernel_size"], kw["in_channels"],
                  kw["num_kernels"]), np.float32)
    return sim._flops(x, w) / sim.flops_per_s


def test_registry_exposes_the_contract():
    names = set(available_backends())
    assert {"numpy", "torch", "cuda", "sim"} <= names
    # every JAX-package backend has its port, xla and pallas by torch and cuda
    assert set(jax_backends.available_backends()) - {"xla", "pallas"} <= names
    for pkg_get in (get_backend, jax_backends.get_backend):
        with pytest.raises(KeyError):
            pkg_get("no-such-backend")


def test_registry_parameterized_instances():
    """"sim:5e9" is a 5 GFLOP/s sim device, cached per parameterized
    name: a cluster can mix sim speeds without the slowdown workaround
    — in both packages, at the same rates."""
    fast = get_backend("sim:5e9")
    slow = get_backend("sim:1e9")
    assert fast is not slow
    assert fast.flops_per_s == pytest.approx(5e9)
    assert slow.flops_per_s == pytest.approx(1e9)
    assert get_backend("sim:5e9") is fast  # each name caches its own
    assert get_backend("sim") is not fast
    assert get_backend("torch:cpu") is get_backend("torch:cpu")
    for name in ("sim", "sim:5e9", "sim:1e9"):
        assert get_backend(name).flops_per_s == jax_backends.get_backend(name).flops_per_s
    with pytest.raises(ValueError, match="rejected parameter"):
        get_backend("sim:not-a-number")
    with pytest.raises(ValueError, match="rejected parameter"):
        get_backend("sim:-1e9")
    with pytest.raises(KeyError):
        get_backend("no-such-backend:5e9")


def test_parameterized_sim_cluster_shares():
    """Two sim devices at different registry-parameter speeds: the
    nominal probe seconds (the JAX package's) are 4x apart; each of a
    few real probes is at least its nominal time (a sleep only
    oversleeps), and the slow device's fastest probe is slower than the
    fast one's; Eq. 1 on those minima splits as the JAX package does."""
    nominal = [_nominal_s(pkg, name, CLUSTER_PROBE)
               for pkg in (backends, jax_backends) for name in ("sim:4e9", "sim:1e9")]
    assert nominal[:2] == nominal[2:]
    assert nominal[1] == pytest.approx(4.0 * nominal[0])
    c = HeteroCluster([1.0, 1.0], ["sim:4e9", "sim:1e9"])
    try:
        probes = [c.probe(repeats=1, **CLUSTER_PROBE) for _ in range(REAL_PROBES)]
        fastest = [min(p[i] for p in probes) for i in range(2)]
        assert fastest[0] >= nominal[0] and fastest[1] >= nominal[1]
        assert fastest[1] > fastest[0]
        c.probe_times = fastest
        counts = c.shares_for(20)
        assert counts[0] > counts[1]
    finally:
        c.shutdown()
    ref = JaxHeteroCluster([1.0, 1.0], ["sim:4e9", "sim:1e9"])
    try:
        ref.probe_times = fastest
        assert counts.tolist() == ref.shares_for(20).tolist()
    finally:
        ref.shutdown()


@pytest.mark.parametrize("name", PARITY_BACKENDS)
def test_conv_parity(name):
    x, w, _ = _data()
    got = _backend(name).conv(x, w)
    np.testing.assert_allclose(got, np.asarray(_ref_conv(x, w)), atol=1e-4)
    np.testing.assert_allclose(got, jax_backends.get_backend("numpy").conv(x, w), atol=1e-4)


@pytest.mark.parametrize("name", PARITY_BACKENDS)
def test_conv_vjp_parity(name):
    x, w, g = _data(seed=1)
    _, pullback = jax.vjp(_ref_conv, jnp.asarray(x), jnp.asarray(w))
    dx_want, dw_want = pullback(jnp.asarray(g))
    dx, dw = _backend(name).conv_vjp(x, w, g)
    np.testing.assert_allclose(dx, np.asarray(dx_want), atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_want), atol=1e-4)


def test_even_kernel_backends_self_consistent():
    """Even kernels: the repo's numpy conv pads SAME k//2-low (XLA's
    differs); the port's numpy, torch:cpu and cuda backends agree with
    it, and with the JAX package's numpy backend."""
    x, w, g = _data(cout=6, k=4, seed=2)
    ref = jax_backends.get_backend("numpy")
    dx_r, dw_r = ref.conv_vjp(x, w, g)
    for name in PARITY_BACKENDS:
        b = _backend(name)
        np.testing.assert_allclose(b.conv(x, w), ref.conv(x, w), atol=1e-4, err_msg=name)
        dx, dw = b.conv_vjp(x, w, g)
        np.testing.assert_allclose(dx, dx_r, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(dw, dw_r, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("name", ["numpy", "torch:cpu", "sim"])
def test_probe_times_every_backend(name):
    kw = dict(image_size=8, in_channels=3, kernel_size=3, num_kernels=4, batch=2,
              repeats=1)
    t = probe_conv_time(name, **kw)
    assert t > 0
    if name == "sim":  # a sleep only oversleeps its nominal time
        assert t >= _nominal_s(backends, name, kw) == _nominal_s(jax_backends, name, kw)


def test_probe_slowdown_scales_measurement():
    """The emulated slowdown multiplies the measured median — in BOTH
    directions, as in the JAX package: a slowdown < 1 emulates a FASTER
    device and shrinks the probe time too.  200x factors dwarf scheduler
    noise on a loaded host, so the ordering is safe to assert."""
    kw = dict(image_size=8, in_channels=3, kernel_size=3,
              num_kernels=4, batch=2, repeats=1)
    base = probe_conv_time("numpy", **kw)
    slowed = probe_conv_time("numpy", slowdown=200.0, **kw)
    assert slowed > base
    sped = probe_conv_time("numpy", slowdown=1.0 / 200.0, **kw)
    assert sped < base
    for probe in (probe_conv_time, jax_backends.probe_conv_time):
        with pytest.raises(ValueError, match="positive"):
            probe("numpy", slowdown=0.0, **kw)


class _SimClock:
    """A clock that only ``time.sleep`` advances: under it a ``sim``
    probe measures exactly its nominal seconds."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s


def test_sim_probe_slowdown_below_one_exact(monkeypatch):
    """On the sim backend the scaling is exact: on a clock that only its
    sleeps advance, the probe at slowdown s is s x its nominal seconds,
    the JAX package's probe gives the same numbers; and on the real
    clock the minimum of a few probes at 0.25 stays below the minimum
    unscaled one, each at least its nominal time."""
    nominal = _nominal_s(backends, "sim", SIM_PROBE)
    assert nominal == _nominal_s(jax_backends, "sim", SIM_PROBE)
    real = [(probe_conv_time("sim", repeats=1, **SIM_PROBE),
             probe_conv_time("sim", slowdown=0.25, repeats=1, **SIM_PROBE))
            for _ in range(REAL_PROBES)]
    base, fast = (min(r[i] for r in real) for i in range(2))
    assert base >= nominal and fast >= 0.25 * nominal
    assert fast < base
    for pkg in (backends, jax_backends):
        clock = _SimClock()
        monkeypatch.setattr(pkg, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter, sleep=clock.sleep))
        base = pkg.probe_conv_time("sim", repeats=1, **SIM_PROBE)
        fast = pkg.probe_conv_time("sim", slowdown=0.25, repeats=1, **SIM_PROBE)
        assert base == pytest.approx(nominal, rel=1e-9)
        assert fast == pytest.approx(0.25 * nominal, rel=1e-9)


def test_sim_backend_shapes_only():
    x, w, g = _data()
    for sim in (get_backend("sim"), jax_backends.get_backend("sim")):
        assert sim.conv(x, w).shape == (2, 8, 8, 7)
        dx, dw = sim.conv_vjp(x, w, g)
        assert dx.shape == x.shape and dw.shape == w.shape


@pytest.mark.parametrize("name", CONV_FNS)
def test_make_conv_fn_grads_match_reference(name):
    """The torch-level conv_fn of each backend is differentiable and
    matches the JAX package's lax conv end to end (forward + grads, bias
    included)."""
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(3, 3, 2, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    xn = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jax_apply_conv(p, jnp.asarray(xn)) ** 2)

    jparams = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    ref = float(jloss(jparams))
    g_ref = jax.grad(jloss)(jparams)

    cluster = None
    if name == "numpy":
        cluster = HeteroCluster([1.0], ["numpy"])
        cluster.probe_times = [1.0]
        conv_fn = make_distributed_conv(cluster)
    else:
        conv_fn = conv_fn_for_backend(name)
    try:
        params = {"kernel": torch.from_numpy(kernel).requires_grad_(),
                  "bias": torch.from_numpy(bias).requires_grad_()}
        got = torch.sum(conv_fn(params, torch.from_numpy(xn)) ** 2)
        grads = torch.autograd.grad(got, [params["kernel"], params["bias"]])
    finally:
        if cluster is not None:
            cluster.shutdown()
    np.testing.assert_allclose(float(got.detach()), ref, rtol=1e-4)
    for g, key in zip(grads, ("kernel", "bias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref[key]), atol=1e-3)


@pytest.fixture(scope="module")
def mixed_cluster():
    """Heterogeneous cluster where the devices run DIFFERENT backends:
    a numpy master, a torch:cpu and a cuda slave (the cuda backend's
    plain path without a card: ``torch:cpu``)."""
    cuda = "cuda" if torch.cuda.is_available() else "torch:cpu"
    c = HeteroCluster([1.0, 1.5, 2.0], ["numpy", "torch:cpu", cuda])
    c.probe(image_size=8, in_channels=3, kernel_size=5, num_kernels=8, batch=2)
    yield c
    c.shutdown()


def test_mixed_cluster_forward_matches_reference(mixed_cluster):
    x, w, _ = _data(s=16, cout=21, seed=4)  # odd count: uneven shards
    got = mixed_cluster.conv_forward(x, w)
    np.testing.assert_allclose(got, np.asarray(_ref_conv(x, w)), atol=1e-4)


def test_mixed_cluster_backward_matches_reference(mixed_cluster):
    x, w, g = _data(s=16, cout=21, seed=5)
    _, pullback = jax.vjp(_ref_conv, jnp.asarray(x), jnp.asarray(w))
    dx_want, dw_want = pullback(jnp.asarray(g))
    dx, dw = mixed_cluster.conv_backward(x, w, g)
    np.testing.assert_allclose(dx, np.asarray(dx_want), atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_want), atol=1e-4)


def test_mixed_cluster_end_to_end_cnn():
    """Full CNN loss + grads through a mixed-backend distributed conv
    equal the JAX package's local single-device model, from its params.
    The master is torch:cpu: the JAX package refuses a non-numpy master
    (its host callbacks), the port's autograd Function does not."""
    cluster = HeteroCluster([1.0, 1.5, 2.0], ["torch:cpu", "numpy", "torch:cpu"])
    cluster.probe(image_size=8, in_channels=3, kernel_size=5,
                  num_kernels=8, batch=2)
    try:
        _check_cnn_end_to_end(cluster)
    finally:
        cluster.shutdown()


def _check_cnn_end_to_end(cluster):
    jcfg = jax_make_cnn_config(6, 10)
    jparams = jax_init_cnn(jax.random.key(0), jcfg)
    jimgs = jax.random.normal(jax.random.key(1), (4, 32, 32, 3))
    jlabels = jnp.array([0, 1, 2, 3])
    loss_ref, _ = jax_cnn_loss(jparams, jimgs, jlabels, cfg=jcfg)
    g_ref = jax.grad(lambda p: jax_cnn_loss(p, jimgs, jlabels, cfg=jcfg)[0])(jparams)

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = {(l, n): t.requires_grad_() for l, d in params.items() for n, t in d.items()}
    loss_dist, _ = cnn_loss(params, torch.from_numpy(np.array(jimgs)),
                            torch.from_numpy(np.array(jlabels)), cfg=make_cnn_config(6, 10),
                            conv_fn=make_distributed_conv(cluster))
    assert np.isclose(float(loss_ref), float(loss_dist.detach()), atol=1e-5)
    grads = torch.autograd.grad(loss_dist, list(leaves.values()))
    for (l, n), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref[l][n]), atol=1e-4)


def test_probe_reflects_backend_not_just_device(mixed_cluster):
    """Eq. 1 input: every entry positive, one per device; the split the
    JAX package's cluster makes from the same times."""
    assert len(mixed_cluster.probe_times) == 3
    assert all(t > 0 for t in mixed_cluster.probe_times)
    counts = mixed_cluster.shares_for(64)
    assert counts.sum() == 64 and (counts >= 0).all()
    ref = JaxHeteroCluster([1.0, 1.5, 2.0])
    try:
        ref.probe_times = list(mixed_cluster.probe_times)
        assert counts.tolist() == ref.shares_for(64).tolist()
    finally:
        ref.shutdown()
