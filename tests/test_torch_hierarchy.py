"""The port's two-tier hierarchy against the JAX package's, on the CPU.

Each of tests/test_hierarchy.py's tests runs here on both packages with
the same numpy inputs (``_data``'s seed): the port's devices are named
explicitly (``numpy`` and ``torch:cpu``), since its default is the card.

- The units (group-aggregate Eq. 1 time and capacity, ``parse_groups``
  and its bad specs, the shared NIC) give equal answers in both.
- The two-tier gradients — inproc 2x3 and tcp 2x2, one group, one-device
  groups, a zero-row group, through ``admit_group``/``evict`` and inner
  churn, and after a leaf or a whole sub-master is SIGKILLed mid-step —
  match the JAX package's ``HierarchicalCluster`` and the single-device
  VJP at rtol 1e-4, atol 1e-3 (the reference's ``_assert_grads``).
- ``run_hetero(groups="2x2")`` on the CPU gives the JAX package's
  ``make_cluster_train_step`` over its ``HierarchicalCluster`` from the
  same params (carried across with ``convert.py``): loss atol 1e-5,
  params atol 1e-4 (tests/test_train_pipeline.py's tolerances).
- Without a card, a hierarchy with default backends refuses to start.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CNNConfig as JaxCNNConfig
from repro.core.cluster import plans as jax_plans
from repro.core.cluster.hierarchy import GroupSpec as JaxGroupSpec
from repro.core.cluster.hierarchy import HierarchicalCluster as JaxHierarchicalCluster
from repro.core.cluster.hierarchy import build_group_cluster as jax_build_group_cluster
from repro.core.cluster.hierarchy import group_hello_meta as jax_group_hello_meta
from repro.core.cluster.hierarchy import parse_groups as jax_parse_groups
from repro.core.cluster.transport import SharedNIC as JaxSharedNIC
from repro.models import cnn as jax_cnn
from repro_torch import convert
from repro_torch.core.cluster import plans
from repro_torch.core.cluster.hierarchy import (
    GroupSpec,
    HierarchicalCluster,
    build_group_cluster,
    group_hello_meta,
    parse_groups,
)
from repro_torch.core.cluster.transport import SharedNIC
from repro_torch.launch.hetero import run_hetero, train_inputs
from repro_torch.models.cnn import make_cnn_config

PROBE = dict(image_size=8, in_channels=3, kernel_size=3, num_kernels=4,
             batch=4, repeats=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(batch, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 3, 6)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 6, 9)).astype(np.float32)
    g = rng.normal(size=(batch, 8, 8, 9)).astype(np.float32)
    return x, w1, w2, g


def _single_device_grads(x, w1, w2, g):
    def f(x_, w1_, w2_):
        y = jax.nn.relu(jax.lax.conv_general_dilated(
            x_, w1_, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ))
        y2 = jax.lax.conv_general_dilated(
            y, w2_, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
        )
        return jnp.sum(y2 * g)

    return tuple(
        np.asarray(a)
        for a in jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2)
        )
    )


def _train_chain(c, x, w1, w2, g, between_first=None):
    def between(y):
        if between_first is not None:
            between_first()
        mask = (y > 0).astype(np.float32)
        return np.maximum(y, 0.0), lambda gz: gz * mask

    slices = c.microbatch_slices(x.shape[0])

    def head(z, i):
        return None, g[slices[i]]

    return c.conv_train_chain(x, [w1, w2], [between, None], head)


def _grads(res):
    return (res.dx, res.dw[0], res.dw[1])


def _assert_grads(got, want, atol=1e-3):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


def _check(port_res, jax_res, want):
    """The port's gradients against the single-device VJP and against
    the JAX package's hierarchy on the same inputs."""
    _assert_grads(_grads(port_res), want)
    _assert_grads(_grads(jax_res), want)
    _assert_grads(_grads(port_res), _grads(jax_res))


# ---------------------------------------------------------------- units


@pytest.mark.parametrize("times,want", [
    ([2.0, 2.0], 1.0),
    ([1.0, 10.0], 1.0 / (1.0 + 0.1)),
    ([3.0], 3.0),
])
def test_group_aggregate_time_harmonic(times, want):
    got = plans.group_aggregate_time(times)
    assert got == jax_plans.group_aggregate_time(times)
    assert got == pytest.approx(want)
    assert got <= min(times)


@pytest.mark.parametrize("times", [[], [1.0, 0.0], [-1.0]])
def test_group_aggregate_time_rejects_bad_input(times):
    for mod in (plans, jax_plans):
        with pytest.raises(ValueError):
            mod.group_aggregate_time(times)


def test_group_capacity_bandwidth_bottleneck():
    for mod in (plans, jax_plans):
        t, bw = mod.group_capacity([2.0, 2.0], [100.0, 50.0, None])
        assert t == pytest.approx(1.0) and bw == 50.0
        assert mod.group_capacity([1.0], [None, None])[1] is None


def test_parse_groups():
    for mod in (parse_groups, jax_parse_groups):
        specs = mod("2x3")
        assert [s.size for s in specs] == [3, 3]
        assert all(s.slowdowns == [1.0, 1.0, 1.0] for s in specs)
        assert all(s.backends is None for s in specs)
    kw = dict(slowdowns=[1.0, 2.0, 3.0, 4.0],
              backends=["numpy", "sim", "numpy", "torch:cpu"], transport="tcp")
    ours, theirs = parse_groups("2x2", **kw), jax_parse_groups("2x2", **kw)
    assert ours[0].slowdowns == [1.0, 2.0] and ours[1].slowdowns == [3.0, 4.0]
    assert ours[1].backends == ["numpy", "torch:cpu"]
    assert [vars(s) for s in ours] == [vars(s) for s in theirs]
    for bad in ("2", "0x3", "2x0", "axb", "2x3x4"):
        for mod in (parse_groups, jax_parse_groups):
            with pytest.raises(ValueError):
                mod(bad)
    for mod in (parse_groups, jax_parse_groups):
        with pytest.raises(ValueError):
            mod("2x3", slowdowns=[1.0])  # needs 6
        with pytest.raises(ValueError):
            mod("2x3", backends=["numpy"])


@pytest.mark.parametrize("nic_cls", [SharedNIC, JaxSharedNIC])
def test_shared_nic_serializes_per_direction(nic_cls):
    nic = nic_cls(bandwidth_mbps=8.0)  # 1e6 bytes/s
    t0 = time.perf_counter()
    a = nic.reserve("down", 100_000)  # 0.1s transit
    b = nic.reserve("down", 100_000)  # queued behind a
    assert b >= a + 0.099
    c = nic.reserve("up", 100_000)  # the other direction is its own port
    assert c < b
    assert a >= t0
    with pytest.raises(ValueError):
        nic_cls(0.0)


# ----------------------------------------------------- two-tier numerics


def test_hierarchy_inproc_matches_jax_and_single_device():
    """A 2x3 two-tier cluster of numpy and torch:cpu devices: the root's
    sum of per-group full dW over disjoint rows is the exact all-reduce.
    The second step rides the WeightRef token path at both tiers."""
    x, w1, w2, g = _data(batch=12)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("2x3", microbatches=3)
    c = HierarchicalCluster(
        parse_groups("2x3", backends=["torch:cpu", "numpy", "numpy"] * 2),
        master_backend="numpy", microbatches=3,
    )
    try:
        assert c.n_slaves == 2
        assert [g_.n_slaves for g_ in c.group_clusters] == [2, 2]
        assert c.backends == ["numpy", "torch:cpu", "torch:cpu"]
        for cl in (jc, c):
            cl.probe(**PROBE)
        for dev in c.slave_ids:
            assert c.hello_meta[dev]["group"]["size"] == 3
            assert c.hello_meta[dev] == jc.hello_meta[dev]
        for _ in range(2):
            _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_hierarchy_tcp_matches_jax_and_single_device():
    """Over the real wire: each sub-master is an OS process spawned with
    ``--group-*`` flags, mastering its own in-proc group."""
    x, w1, w2, g = _data(batch=8)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("2x2", transport="tcp", microbatches=2)
    c = HierarchicalCluster(
        parse_groups("2x2", backends=["numpy", "torch:cpu"] * 2),
        master_backend="torch:cpu", transport="tcp", microbatches=2,
    )
    try:
        assert c.n_slaves == 2
        assert c.group_clusters == []  # groups live in the subprocesses
        for dev in c.slave_ids:
            assert c.hello_meta[dev]["group"] == {"size": 2, "bandwidth_mbps": None}
            assert c.hello_meta[dev]["group"] == jc.hello_meta[dev]["group"]
        for cl in (jc, c):
            cl.probe(**PROBE)
        for _ in range(2):
            _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


# ------------------------------------------- degenerate topologies plan


def test_single_group_plans_and_trains():
    """G = 1: batch ranges over the root and one aggregate group tile."""
    x, w1, w2, g = _data(batch=6)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("1x3", microbatches=3)
    c = HierarchicalCluster(parse_groups("1x3", backends=["numpy", "torch:cpu", "numpy"]),
                            master_backend="torch:cpu", microbatches=3)
    try:
        for cl in (jc, c):
            cl.probe_times = [1.0, 0.5]  # pinned: the group aggregates faster
        plan = c.plan_conv(x.shape, w1, "train")
        plans.check_plan(plan, n_units=6, n_devices=2)
        assert list(plan.counts) == list(jc.plan_conv(x.shape, w1, "train").counts)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_one_device_groups_plan_and_train():
    """M = 1: each inner cluster is master-only (zero slaves)."""
    x, w1, w2, g = _data(batch=6)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("2x1", microbatches=3)
    c = HierarchicalCluster(parse_groups("2x1", backends=["torch:cpu", "numpy"]),
                            master_backend="numpy", microbatches=3)
    try:
        assert [g_.n_slaves for g_ in c.group_clusters] == [0, 0]
        times = c.probe(**PROBE)
        jc.probe(**PROBE)
        assert len(times) == 3 and all(t > 0 for t in times)
        plans.check_plan(c.plan_conv(x.shape, w1, "train"), n_units=6, n_devices=3)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_zero_row_group_short_circuits():
    """A group priced so slow that it draws zero rows: its zero-row
    conv/bwd short-circuit (``scheduler.group_forward``/``_backward``)."""
    x, w1, w2, g = _data(batch=6)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("2x2", microbatches=2)
    c = HierarchicalCluster(parse_groups("2x2", backends=["numpy", "torch:cpu"] * 2),
                            master_backend="numpy", microbatches=2)
    try:
        for cl in (jc, c):
            cl.probe_times = [1.0, 1.0, 1e9]
        plan = c.plan_conv(x.shape, w1, "train")
        plans.check_plan(plan, n_units=6, n_devices=3)
        assert any(n == 0 for n in plan.counts)
        assert list(plan.counts) == list(jc.plan_conv(x.shape, w1, "train").counts)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_group_bandwidth_folds_into_root_planning():
    """A group's internal bottleneck rides the hello meta and caps the
    root's planning bandwidth for that slot."""
    c = HierarchicalCluster(
        [GroupSpec(slowdowns=[1.0, 1.0], backends=["numpy", "numpy"],
                   bandwidth_mbps=50.0),
         GroupSpec(slowdowns=[1.0, 1.0], backends=["numpy", "torch:cpu"])],
        master_backend="numpy", bandwidth_mbps=1000.0,
    )
    jc = JaxHierarchicalCluster(
        [JaxGroupSpec(slowdowns=[1.0, 1.0], bandwidth_mbps=50.0),
         JaxGroupSpec(slowdowns=[1.0, 1.0])],
        bandwidth_mbps=1000.0,
    )
    try:
        metas = [c.hello_meta[d]["group"] for d in c.slave_ids]
        assert metas == [jc.hello_meta[d]["group"] for d in jc.slave_ids]
        assert metas[0]["bandwidth_mbps"] == 50.0
        assert metas[1]["bandwidth_mbps"] is None
        assert c.bandwidths == jc.bandwidths == [50.0, 1000.0]
    finally:
        c.shutdown()
        jc.shutdown()


# --------------------------------------------- elasticity at both tiers


def test_admit_group_and_evict_roundtrip():
    """Root-tier elasticity over whole groups: ``admit_group`` grows the
    root by one sub-master, ``evict`` drains it; gradients stay exact."""
    x, w1, w2, g = _data(batch=6)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("1x2", microbatches=3)
    c = HierarchicalCluster(parse_groups("1x2", backends=["numpy", "torch:cpu"]),
                            master_backend="numpy", microbatches=3)
    try:
        for cl in (jc, c):
            cl.probe(**PROBE)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)

        dev = c.admit_group(GroupSpec(slowdowns=[1.0, 1.0],
                                      backends=["torch:cpu", "numpy"]))
        jdev = jc.admit_group(JaxGroupSpec(slowdowns=[1.0, 1.0]))
        assert dev == jdev and c.n_slaves == 2
        assert c.hello_meta[dev]["group"]["size"] == 2
        assert len(c.group_clusters) == 2
        plans.check_plan(c.plan_conv(x.shape, w1, "train"), n_units=6, n_devices=3)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)

        c.evict(dev)
        jc.evict(jdev)
        assert c.n_slaves == 1
        plans.check_plan(c.plan_conv(x.shape, w1, "train"), n_units=6, n_devices=2)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_inner_tier_admit_evict_reprices_group():
    """Leaf churn inside a group changes only the group's aggregate
    capacity, which ``refresh_capacity`` re-prices; the root's
    membership stays and the gradients stay exact."""
    x, w1, w2, g = _data(batch=6)
    want = _single_device_grads(x, w1, w2, g)
    jc = JaxHierarchicalCluster("2x2", microbatches=3)
    c = HierarchicalCluster(parse_groups("2x2", backends=["numpy"] * 4),
                            master_backend="numpy", microbatches=3)
    try:
        t_before = c.probe(**PROBE)
        jc.probe(**PROBE)
        root_ids_before = list(c.slave_ids)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)

        for cl in (c, jc):
            inner = cl.group_clusters[0]
            inner.evict(inner.slave_ids[0])  # a leaf leaves its group
            assert inner.n_slaves == 0
        t_after = c.refresh_capacity()
        jc.refresh_capacity()
        assert list(c.slave_ids) == root_ids_before
        assert t_after[1] > t_before[1] * 1.2  # the shrunk group is slower
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)

        for cl in (c, jc):
            inner = cl.group_clusters[0]
            dev = inner.admit(1.0, "numpy")  # and a leaf joins back
            assert inner.n_slaves == 1 and dev in inner.slave_ids
            cl.refresh_capacity()
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


# ------------------------------------------------ composed chaos domains


def _tcp_groups(mod, backends):
    return [mod(slowdowns=[1.0, 1.0, 1.0], backends=backends, transport="tcp",
                heartbeat_s=2.0, microbatches=2) for _ in range(2)]


def test_leaf_sigkill_recovers_inside_group_invisible_to_root():
    """SIGKILL a leaf mid-step: its group's sub-master evicts it and
    recomputes its rows; the root sees no failure."""
    x, w1, w2, g = _data(batch=8)
    want = _single_device_grads(x, w1, w2, g)
    c = HierarchicalCluster(_tcp_groups(GroupSpec, ["numpy", "torch:cpu", "numpy"]),
                            master_backend="numpy", microbatches=2)
    jc = JaxHierarchicalCluster(_tcp_groups(JaxGroupSpec, None), microbatches=2)
    try:
        results = []
        for cl in (c, jc):
            cl.probe(**PROBE)
            inner = cl.group_clusters[0]
            victim_proc, victim_dev = inner.procs[0], inner.slave_ids[0]
            fired = []

            def kill_once(proc=victim_proc, fired=fired):
                if not fired:
                    fired.append(True)
                    proc.kill()

            results.append(_train_chain(cl, x, w1, w2, g, kill_once))
            assert [f["device"] for f in inner.failures] == [victim_dev]
            assert inner.n_slaves == 1
            assert cl.failures == [] and cl.n_slaves == 2
        _check(*results, want)
        for cl in (c, jc):
            cl.refresh_capacity()
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_submaster_sigkill_root_recovers_whole_group():
    """SIGKILL a whole sub-master process mid-step: one dead batch
    member to the root, whose rows it recomputes; the next step
    re-plans over the surviving group."""
    x, w1, w2, g = _data(batch=6)
    want = _single_device_grads(x, w1, w2, g)
    c = HierarchicalCluster(parse_groups("2x2", backends=["numpy", "torch:cpu"] * 2),
                            master_backend="numpy", transport="tcp",
                            microbatches=3, heartbeat_s=2.0)
    jc = JaxHierarchicalCluster("2x2", transport="tcp", microbatches=3,
                                heartbeat_s=2.0)
    try:
        results = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            victim_proc, victim_dev = cl.procs[0], cl.slave_ids[0]
            fired = []

            def kill_once(proc=victim_proc, fired=fired):
                if not fired:
                    fired.append(True)
                    proc.kill()

            results.append(_train_chain(cl, x, w1, w2, g, kill_once))
            assert [f["device"] for f in cl.failures] == [victim_dev]
            assert cl.n_slaves == 1
            assert cl.timing.recompute_s > 0.0
            plans.check_plan(cl.plan_conv(x.shape, w1, "train"), n_units=6,
                             n_devices=2)
        _check(*results, want)
        _check(_train_chain(c, x, w1, w2, g), _train_chain(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_group_hello_meta_shape():
    """Size counts the sub-master's own compute; bandwidth is the min
    finite member link (None when every inner link is unmetered)."""
    cases = [(dict(slowdowns=[1.0, 1.0, 1.0]), {"size": 3, "bandwidth_mbps": None}),
             (dict(slowdowns=[1.0, 1.0], bandwidth_mbps=25.0),
              {"size": 2, "bandwidth_mbps": 25.0})]
    for kw, want in cases:
        n = len(kw["slowdowns"])
        for build, spec, meta in (
                (build_group_cluster, GroupSpec(backends=["numpy"] * n, **kw),
                 group_hello_meta),
                (jax_build_group_cluster, JaxGroupSpec(**kw), jax_group_hello_meta)):
            inner = build(spec)
            try:
                assert meta(inner) == want
            finally:
                inner.shutdown()


# ------------------------------------------- the grouped training step


def test_run_hetero_groups_matches_jax_cluster_step():
    """``run_hetero(groups="2x2")`` on the CPU against the JAX package's
    ``make_cluster_train_step`` over its ``HierarchicalCluster``, from
    the same params and batch (``train_inputs``, carried across)."""
    c1, c2, batch, steps, lr = 4, 8, 4, 2, 0.05
    rec, history = run_hetero([1.0], device="cpu", train_pipeline=True,
                              groups="2x2", group_partition="kernel", c1=c1,
                              c2=c2, batch=batch, steps=steps, lr=lr,
                              microbatches=2)
    assert rec["topology"] == "2x2" and rec["partition"] == "batch"
    assert rec["backends"] == ["torch:cpu"] * 3
    assert len(rec["group_shares"]) == 2 and len(rec["losses"]) == steps
    cfg = make_cnn_config(c1, c2)
    params, images, labels = train_inputs(cfg, batch, "cpu")
    p = convert.params_to_numpy(params)
    images, labels = images.numpy(), labels.numpy().astype(np.int32)
    jcfg = JaxCNNConfig(**vars(cfg))
    jc = JaxHierarchicalCluster(jax_parse_groups("2x2", partition="kernel",
                                                 microbatches=2),
                                microbatches=2)
    try:
        jc.probe(image_size=32, in_channels=3, kernel_size=5,
                 num_kernels=8, batch=batch)
        step = jax_cnn.make_cluster_train_step(jc, jcfg, lr=lr)
        for got_loss, got in zip(rec["losses"], history):
            p, loss, _ = step(p, images, labels)
            p = jax.tree.map(np.asarray, p)
            assert abs(got_loss - float(loss)) <= 1e-5
            got = convert.params_to_numpy(got)
            for layer in p:
                for name in p[layer]:
                    np.testing.assert_allclose(got[layer][name], p[layer][name],
                                               atol=1e-4, rtol=0,
                                               err_msg=f"{layer}/{name}")
    finally:
        jc.shutdown()


def test_default_backends_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HierarchicalCluster("2x2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HierarchicalCluster(parse_groups("1x2", backends=["numpy", "cuda"]),
                            master_backend="numpy")


def test_processes_that_start_together_compile_a_kernel_once(tmp_path):
    """Sub-masters spawned together each load the conv libraries: of
    processes that reach an unbuilt library at once, one runs nvcc and
    the others wait on the file lock and load its library (a stand-in
    nvcc counts the compiles)."""
    import os
    import subprocess
    import sys

    count = tmp_path / "compiles"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\nsleep 0.5\necho x >> " + str(count) + "\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done\n'
        'echo lib > "$out"\n'
    )
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    code = (
        "import sys\nfrom pathlib import Path\n"
        "from repro_torch.kernels import _build\n"
        f"_build._nvcc = lambda: {str(nvcc)!r}\n"
        f"d = Path({str(tmp_path)!r})\n"
        "print(_build._compile_once(d / 'k.cu', d / 'k_0.so', d / 'k_0.ptxas.txt')[1])\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True) for _ in range(3)]
    hits = sorted(p.communicate(timeout=60)[0].strip() for p in procs)
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert hits == ["False", "True", "True"]
    assert count.read_text().count("x") == 1
    assert (tmp_path / "k_0.so").read_text() == "lib\n"
    assert not list(tmp_path.glob("*.tmp"))


def test_run_hetero_refuses_groups_with_expected_slaves():
    """``--groups`` spawns its own sub-masters: hand-launched joins stay a
    flat-cluster feature, refused before any cluster starts."""
    with pytest.raises(SystemExit, match="expected-slaves"):
        run_hetero([1.0], device="cpu", train_pipeline=True, groups="2x2",
                   expected_slaves=1, transport="tcp")
