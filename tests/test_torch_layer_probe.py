"""Eq. 1 per layer in training: a ``conv_train_chain`` plan over a
cluster that ``probe()`` measured splits each conv layer by every
device's time of the reference convolution at THAT layer's geometry
(``HeteroCluster.layer_probe``), kept in a table per geometry that
follows membership.  Pinned ``probe_times``, a one-device cluster,
forward plans and serving plans keep the cluster-wide probe, and split
exactly as the JAX package does.

The devices of the first test are a backend registered here: a fixed
cost per call plus a cost per FLOP (no arithmetic), so a card-like
device (a large fixed cost, a fast rate) and a CPU-like one (no fixed
cost, a slow rate) rank one way on a shallow layer and the other way on
a deep one, as a card and the host's CPU do on conv1 and conv2.

The master is probed where its part of the op runs: a card-path chain
(its input a tensor on the master's device, the kernel axis) times it
on tensors there, a host-path chain on numpy operands.  The master of
those tests is another backend registered here, a device of torch CPU
tensors that takes long on numpy operands (its copies) and little on
tensors."""
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from _torch_cluster_parity import clusters, data, train_step
from repro.core.cluster import scheduler as jax_scheduler
from repro_torch.core import spans
from repro_torch.core import backends
from repro_torch.core.backends import (
    ConvBackend,
    CudaBackend,
    get_backend,
    probe_conv_time,
    register_backend,
)
from repro_torch.core.cluster import scheduler
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.core.cluster.scheduler import ServeChain
from repro_torch.core.partitioner import allocate_kernels
from repro_torch.models.cnn import init_cnn, make_cluster_train_step, make_cnn_config

CARD = "fixedcost:0.02:1e12"  # 20 ms a call, then 1 TFLOP/s
CPU = "fixedcost:0:1e8"       # no fixed cost, 0.1 GFLOP/s
GEOMETRY = ("image_size", "in_channels", "kernel_size", "num_kernels", "batch")


@register_backend("fixedcost")
class FixedCostBackend(ConvBackend):
    """Sleeps ``fixed_s + flops / flops_per_s`` a call (the VJP twice the
    FLOPs; ``"fixedcost:<fixed_s>:<flops_per_s>"``) and returns zeros of
    the right shapes, as the ``sim`` backend does: a device of known
    speed, free of the host's compute noise, never for numerics."""

    name = "fixedcost"

    def __init__(self, param):
        fixed, rate = param.split(":")
        self.fixed_s, self.flops_per_s = float(fixed), float(rate)

    def _take(self, x, w, mult):
        b, h, wd, _ = x.shape
        kh, kw, cin, cout = w.shape
        time.sleep(self.fixed_s + mult * 2.0 * b * h * wd * kh * kw * cin * cout
                   / self.flops_per_s)

    def conv(self, x, w):
        self._take(x, w, 1.0)
        return np.zeros(x.shape[:-1] + (w.shape[-1],), np.float32)

    def conv_vjp(self, x, w, g):
        self._take(x, w, 2.0)
        return np.zeros(x.shape, np.float32), np.zeros(w.shape, np.float32)


PLACED = "placed:0.05:0.001"  # 50 ms a call on numpy operands, 1 ms on tensors


@register_backend("placed")
class PlacedBackend(ConvBackend):
    """Sleeps ``host_s`` a call on numpy operands and ``card_s`` on
    tensors (``"placed:<host_s>:<card_s>"``) and answers with zeros
    where its operands lie: a device of torch CPU tensors whose copies
    cost, as a card's do, never for numerics.  ``calls`` keeps, per
    ``conv`` call, whether its x was a tensor."""

    name = "placed"

    def __init__(self, param):
        host, card = param.split(":")
        self.host_s, self.card_s = float(host), float(card)
        self.device = torch.device("cpu")
        self.calls = []

    def _zeros(self, x, shape):
        on_card = isinstance(x, torch.Tensor)
        time.sleep(self.card_s if on_card else self.host_s)
        return torch.zeros(shape) if on_card else np.zeros(shape, np.float32)

    def conv(self, x, w):
        self.calls.append(isinstance(x, torch.Tensor))
        return self._zeros(x, tuple(x.shape[:-1]) + (w.shape[-1],))

    def conv_vjp(self, x, w, g):
        return self._zeros(x, tuple(x.shape)), self._zeros(x, tuple(w.shape))


@register_backend("cuda_on_cpu_probe")
def _cuda_on_cpu():
    """``CudaBackend`` on CPU tensors: its seam and spans around the
    kernels' plain versions."""
    backend = CudaBackend.__new__(CudaBackend)
    backend.device = torch.device("cpu")
    return backend


def _profiler():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _off_boundary():
    """A boundary passed while no profiler records (it ends a session)."""
    spans.record("test.off", time.perf_counter(), time.perf_counter())


@pytest.fixture
def chain_plans(monkeypatch):
    """The plans each cluster's chains build, in order, by package."""
    got = {"port": [], "jax": []}
    for mod, key in ((scheduler, "port"), (jax_scheduler, "jax")):
        real = mod.plan_conv

        def spy(*a, _real=real, _key=key, **kw):
            plan = _real(*a, **kw)
            got[_key].append(plan)
            return plan

        monkeypatch.setattr(mod, "plan_conv", spy)
    return got


def _chain(c, x, ws, between=None):
    """One training chain over the layers ``ws`` (ReLU between them), the
    chain's output as the head's gradient."""
    def relu(y):
        m = (y > 0).astype(np.float32)
        return np.maximum(y, 0.0), lambda gz: gz * m

    between = between or [relu] * (len(ws) - 1) + [None]
    return c.conv_train_chain(x, ws, between, lambda z, i: (None, z))


def _mb(*shape, card=False):
    """A microbatch of ``shape``: a CPU tensor (``card``: on the
    ``placed`` master's device) or numpy."""
    return torch.zeros(shape) if card else np.zeros(shape, np.float32)


def _rng_weights(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_each_layer_is_split_by_its_own_probe(chain_plans):
    x, w1, w2 = _rng_weights(0, (4, 8, 8, 3), (3, 3, 3, 64), (5, 5, 64, 32))
    c = HeteroCluster([1.0, 1.0], [CARD, CPU], pipeline=True, microbatches=2,
                      comp_aware=False)
    try:
        # the cluster-wide probe is conv1's geometry at the whole batch
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=64, batch=4)
        for _ in range(2):
            _chain(c, x, [w1, w2])
        plans = chain_plans["port"]
        assert len(plans) == 4
        for k, w in enumerate((w1, w2)):
            layer = c.layer_probe(_mb(2, 8, 8, w.shape[2]), w.shape)  # a table lookup
            assert plans[k].counts.tolist() == plans[k + 2].counts.tolist() == (
                allocate_kernels(w.shape[-1], layer.times).tolist())
            assert layer.flops == 2.0 * 2 * 64 * w.shape[0] ** 2 * w.shape[2] * w.shape[3]
        c1, c2 = (p.counts for p in plans[:2])
        assert c1[1] > 32 and c2[0] > 16  # the shallow layer to the CPU, the deep to the card
        # conv1's times scaled by FLOPs would give conv2 to the CPU as well
        assert c.shares_for(32)[1] > 16
    finally:
        c.shutdown()


@pytest.mark.parametrize("probed_first", [False, True])
def test_pinned_times_split_as_the_jax_package_does(chain_plans, probed_first):
    x, w1, w2, g = data()
    port, jc = clusters([1.0, 1.0, 1.0], pipeline=True, microbatches=2)
    try:
        if probed_first:
            port.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=5)
        for cl in (port, jc):
            cl.probe_times = [1.0, 1.5, 2.0]
        want = [jc.shares_for(6).tolist(), jc.shares_for(9).tolist()]
        _off_boundary()
        with _profiler():
            train_step(port, x, w1, w2, g)
        train_step(jc, x, w1, w2, g)
        got = [p.counts.tolist() for p in chain_plans["port"]]
        assert got == [p.counts.tolist() for p in chain_plans["jax"]]
        assert got == want
        assert port.layer_probe(_mb(3, 8, 8, 3), w1.shape) is None
        assert not port.layer_probe_due(_mb(3, 8, 8, 3), w1.shape)
        names = [s.name for s in spans.spans()]
        assert "cluster.layer_probe" not in names
        assert {s.attrs["eq1"] for s in spans.spans() if s.name == "cluster.plan"} == {"probe"}
    finally:
        port.shutdown()
        jc.shutdown()


def test_a_one_device_cluster_probes_no_layer(chain_plans):
    x, w1, w2 = _rng_weights(1, (4, 8, 8, 3), (3, 3, 3, 6), (3, 3, 6, 9))
    c = HeteroCluster([1.0], ["numpy"], pipeline=True, microbatches=2)
    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=4)
        _off_boundary()
        with _profiler():
            _chain(c, x, [w1, w2])
        assert "cluster.layer_probe" not in {s.name for s in spans.spans()}
        assert c.layer_probe(_mb(2, 8, 8, 3), w1.shape) is None
        assert c._layer_times == {}
        assert [p.counts.tolist() for p in chain_plans["port"]] == [[6], [9]]
    finally:
        c.shutdown()


def test_the_table_follows_membership():
    x, w1, w2 = _rng_weights(2, (4, 8, 8, 3), (3, 3, 3, 6), (3, 3, 6, 9))
    c = HeteroCluster([1.0] * 3, ["numpy"] * 3, pipeline=True, microbatches=2)

    def columns():
        return [sorted(col) for col in c._layer_times.values()]

    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=4)
        _chain(c, x, [w1, w2])
        assert columns() == [[0, 1, 2], [0, 1, 2]]
        c.evict(1)
        assert columns() == [[0, 2], [0, 2]]  # no stale column
        assert not c.layer_probe_due(_mb(2, 8, 8, 3), w1.shape)
        dev = c.admit(1.0, "numpy")
        assert c.layer_probe_due(_mb(2, 8, 8, 3), w1.shape)
        _chain(c, x, [w1, w2])
        assert columns() == [[0, 2, dev], [0, 2, dev]]
        layer = c.layer_probe(_mb(2, 8, 8, 6), w2.shape)
        assert len(layer.times) == 1 + c.n_slaves == 3
        # a new probe() measures anew: every layer is probed again
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=4)
        assert c._layer_times == {} and c.layer_probe_due(_mb(2, 8, 8, 3), w1.shape)
    finally:
        c.shutdown()


def test_a_layer_probe_waits_for_idle_links():
    x, w1 = _rng_weights(3, (4, 8, 8, 3), (3, 3, 3, 6))
    c = HeteroCluster([1.0, 1.0], ["numpy", "numpy"])
    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=4)
        p = c.scatter_conv(x, w1)
        with pytest.raises(RuntimeError, match="idle links"):
            c.layer_probe(x, w1.shape)
        c.gather_conv(p)
        assert len(c.layer_probe(x, w1.shape).times) == 2
    finally:
        c.shutdown()


def _cnn_steps(cluster, steps=2):
    cfg = make_cnn_config(4, 8)
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = np.arange(4) % 10
    step = make_cluster_train_step(cluster, cfg, lr=0.05, device="cpu")
    losses = []
    for _ in range(steps):
        params, loss, _ = step(params, x, labels)
        losses.append(float(loss))
    return losses, {f"{l}.{n}": v.numpy() for l, d in params.items() for n, v in d.items()}


def test_a_step_split_per_layer_matches_the_pinned_split(chain_plans):
    got = {}
    for kind in ("layer", "pinned"):
        c = HeteroCluster([1.0, 1.0], ["numpy", "numpy"], pipeline=True, microbatches=2)
        try:
            c.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=8, batch=4)
            if kind == "pinned":
                c.probe_times = [1.0, 3.0]
            got[kind] = _cnn_steps(c)
        finally:
            c.shutdown()
    (loss_l, p_l), (loss_p, p_p) = got["layer"], got["pinned"]
    np.testing.assert_allclose(loss_l, loss_p, rtol=0, atol=1e-5)
    for k in p_p:
        np.testing.assert_allclose(p_l[k], p_p[k], rtol=0, atol=1e-4, err_msg=k)
    # the pinned run's first step (comp_duty is measured after it)
    assert [p.counts.tolist() for p in chain_plans["port"][4:6]] == [[3, 1], [6, 2]]


def test_the_plan_and_layer_probe_spans_carry_their_labels():
    x, w1, w2 = _rng_weights(4, (4, 8, 8, 3), (3, 3, 3, 6), (5, 5, 6, 10))
    c = HeteroCluster([1.0, 1.0], ["torch:cpu", "numpy"], pipeline=True, microbatches=2)
    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=4)
        _off_boundary()
        with _profiler():
            _chain(c, x, [w1, w2])
            _chain(c, x, [w1, w2])
        sp = spans.spans()
    finally:
        c.shutdown()
    probes = [s.attrs for s in sp if s.name == "cluster.layer_probe"]
    assert [(a["device"], a["backend"]) for a in probes] == [
        (0, "torch:cpu"), (1, "numpy")] * 2
    assert [tuple(a[k] for k in GEOMETRY) for a in probes] == (
        [(8, 3, 3, 6, 2)] * 2 + [(8, 6, 5, 10, 2)] * 2)
    planned = [s.attrs for s in sp if s.name == "cluster.plan"]
    assert [(a["eq1"], a["units"], a["axis"]) for a in planned] == [
        ("layer", 6, "kernel"), ("layer", 10, "kernel")] * 2
    assert all(a["cpu_units"] == a["units"] for a in planned)  # no cuda device here


def test_forward_and_serving_plans_keep_the_cluster_wide_probe(chain_plans):
    x, w1, w2 = _rng_weights(6, (4, 8, 8, 3), (3, 3, 3, 6), (3, 3, 6, 9))
    c = HeteroCluster([1.0, 1.0], ["torch:cpu", "numpy"], pipeline=True, microbatches=2)
    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=4)
        c.conv_forward_chain(x, [w1, w2], [lambda y: np.maximum(y, 0.0), None])
        chain = ServeChain(c, [w1, w2])
        chain.push(x)
        chain.flush()
        want = [c.shares_for(6).tolist(), c.shares_for(9).tolist()]
        assert [p.counts.tolist() for p in chain_plans["port"]] == want * 2
        assert c._layer_times == {}  # no layer was probed
    finally:
        c.shutdown()


def _placed_chain(c, on_card, seed=7):
    """A chain of two layers over ``c``, its input and kernels tensors
    on the CPU (the card path of a master there) or numpy (the host
    path); no stage between them.  Returns the kernels."""
    x, w1, w2 = _rng_weights(seed, (4, 8, 8, 3), (3, 3, 3, 12), (5, 5, 12, 16))
    if on_card:
        x, w1, w2 = (torch.from_numpy(a) for a in (x, w1, w2))
    c.conv_train_chain(x, [w1, w2], [None, None], lambda z, i: (None, z))
    return w1, w2


def _placed_cluster(**kw):
    c = HeteroCluster([1.0, 1.0], [PLACED, "numpy"], pipeline=True, microbatches=2,
                      comp_aware=False, **kw)
    c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=12, batch=4)
    get_backend(PLACED).calls.clear()
    return c


@pytest.mark.parametrize("where", ["card", "host"])
def test_the_master_is_probed_where_its_part_runs(chain_plans, where):
    master = get_backend(PLACED)
    c = _placed_cluster()
    try:
        _off_boundary()
        with _profiler():
            ws = _placed_chain(c, where == "card")
        sp, counted = spans.spans(), spans.counters()["cluster.layer_probe"]
        calls = list(master.calls)
        for plan, w in zip(chain_plans["port"], ws):
            layer = c.layer_probe(_mb(2, 8, 8, w.shape[2], card=where == "card"), w.shape)
            assert plan.counts.tolist() == allocate_kernels(w.shape[-1], layer.times).tolist()
            if where == "card":  # the tensor time, not the numpy time
                assert layer.times[0] < master.host_s / 2
            else:
                assert layer.times[0] >= master.host_s
        assert all(key[0] == where for key in c._layer_times)
    finally:
        c.shutdown()
    # the probe's calls (a warm-up and 3 timed, each layer) and the
    # shard's took the operands of the chain's placement
    assert len(calls) >= 2 * 4 and set(calls) == {where == "card"}
    probes = [s.attrs for s in sp if s.name == "cluster.layer_probe"]
    assert [(a["device"], a["operands"]) for a in probes] == [(0, where), (1, "host")] * 2
    assert counted.s_by.get(("operands", where), 0.0) > 0.0


def test_a_card_path_and_a_host_path_chain_keep_their_own_table_entries():
    master = get_backend(PLACED)
    c = _placed_cluster()
    try:
        w1, w2 = _placed_chain(c, True)
        assert c.layer_probe_due(_mb(2, 8, 8, 3), w1.shape)
        assert not c.layer_probe_due(_mb(2, 8, 8, 3, card=True), w1.shape)
        _placed_chain(c, False)
        assert sorted(key[0] for key in c._layer_times) == ["card"] * 2 + ["host"] * 2
        for w in (w1, w2):
            card = c.layer_probe(_mb(2, 8, 8, w.shape[2], card=True), w.shape)
            host = c.layer_probe(_mb(2, 8, 8, w.shape[2]), w.shape)
            assert card.times[0] < master.host_s / 2 <= master.host_s <= host.times[0]
            assert card.flops == host.flops
        # a table lookup calls nothing
        n = len(master.calls)
        c.layer_probe(_mb(2, 8, 8, 3, card=True), w1.shape)
        assert len(master.calls) == n
    finally:
        c.shutdown()


@pytest.mark.parametrize("partition", ["spatial", "batch", "auto"])
def test_the_other_axes_keep_the_host_probe(partition):
    master = get_backend(PLACED)
    c = _placed_cluster(partition=partition)
    try:
        _off_boundary()
        with _profiler():
            _placed_chain(c, True)
        probes = [s.attrs for s in spans.spans() if s.name == "cluster.layer_probe"]
        assert {key[0] for key in c._layer_times} == {"host"}
        assert {a["operands"] for a in probes} == {"host"}
        for key, col in c._layer_times.items():
            assert col[0] >= master.host_s, key
    finally:
        c.shutdown()


def test_the_probe_placement_follows_the_input_and_the_axis():
    """A tensor on the master's device keys the table ``"card"``; numpy
    input, or any input to a numpy master, ``"host"``."""
    c = HeteroCluster([1.0, 1.0], [PLACED, "numpy"])
    n = HeteroCluster([1.0, 1.0], ["numpy", "numpy"])
    try:
        for cl in (c, n):
            cl.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=2)
        t = torch.zeros((2, 8, 8, 3))
        for cl, x, want in ((c, t, "card"), (c, t.numpy(), "host"),
                            (n, t, "host"), (n, t.numpy(), "host")):
            cl.layer_probe(x, (3, 3, 3, 6))
            assert [key[0] for key in cl._layer_times] == [want], (cl.backends, type(x))
            cl._layer_times.clear()
    finally:
        c.shutdown()
        n.shutdown()


@pytest.mark.parametrize("on_card", [True, False])
def test_a_card_probe_times_tensors_and_drains_each_call(monkeypatch, on_card):
    drained = []
    real = backends.drain
    monkeypatch.setattr(backends, "drain", lambda t: (drained.append(t), real(t)))
    kw = dict(image_size=8, in_channels=3, kernel_size=3, num_kernels=6, batch=2)
    _off_boundary()
    with _profiler():
        t = probe_conv_time("cuda_on_cpu_probe", device="cpu" if on_card else None, **kw)
    names = {(s.name, s.attrs.get("operands")) for s in spans.spans()}
    assert t > 0.0
    if on_card:
        # the operands moved once, under no span; the warm-up and the 3
        # timed calls each end on the drain of a tensor result
        assert names == {("cuda.compute", "card")}
        results = [d for d in drained if d.shape == (2, 8, 8, 6)]
        assert len(results) >= 2 * 4 and all(isinstance(d, torch.Tensor) for d in results)
    else:
        assert {"cuda.to_card", "cuda.to_host"} <= {n for n, _ in names}
        assert ("cuda.compute", "host") in names
