"""The port's cost model (Eq. 2), simulator and ``master_slave`` shim
against the JAX package's.

Both packages keep numpy-only copies of ``core/costmodel.py`` and
``core/simulator.py``: tests/test_costmodel.py's and
tests/test_simulator.py's cases run on both here and must give equal
outputs (the same numpy code on the same inputs: exactly equal).  The
Eq. 2 socket-traffic check runs the port's cluster on numpy devices
against the JAX package's, byte for byte.  The shim keeps the JAX
package's ``core/master_slave.py`` import surface, and ``repro_torch.
core``'s lazy exports match ``repro.core``'s for what the port has.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jax_core
import repro.core.master_slave as jax_master_slave
from repro.core import costmodel as jax_costmodel
from repro.core import simulator as jax_simulator
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
import repro_torch.core as core
import repro_torch.core.master_slave as master_slave
from repro_torch.core import costmodel, simulator

MODS = [costmodel, jax_costmodel]
# what the JAX package exports and the port has no counterpart of yet
# (none since core/conv_shard.py was ported with the mesh layer)
NOT_PORTED = set()


def _same(a, b):
    """Equal outputs, field by field for dataclasses, elementwise for
    arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ cost model


def test_eq2_paper_network_counts():
    batch = 1024
    want = (
        32 ** 2 * 3 * batch + 5 ** 2 * 500 * 3 + 32 ** 2 * 500 * batch
        + 16 ** 2 * 500 * batch + 5 ** 2 * 1500 * 500 + 16 ** 2 * 1500 * batch
    )
    _same(costmodel.paper_network(500, 1500), jax_costmodel.paper_network(500, 1500))
    for mod in MODS:
        layers = mod.paper_network(500, 1500)
        assert mod.upload_elements(layers, batch) == want
        assert mod.upload_bytes(layers, batch) == want * 8


@given(
    st.integers(min_value=1, max_value=64),   # in_size
    st.integers(min_value=1, max_value=16),   # in_channels
    st.integers(min_value=1, max_value=7),    # kernel
    st.integers(min_value=1, max_value=256),  # num kernels
    st.integers(min_value=1, max_value=128),  # batch
)
@settings(max_examples=30)
def test_eq2_positive_and_monotone_in_batch(in_size, in_ch, k, nk, batch):
    got = []
    for mod in MODS:
        layer = [mod.ConvLayerSpec(in_size, in_ch, k, nk)]
        a, b = mod.upload_elements(layer, batch), mod.upload_elements(layer, batch + 1)
        assert 0 < a < b
        got.append((a, b))
    assert got[0] == got[1]


def test_comm_time_at_paper_bandwidth():
    secs = []
    for mod in MODS:
        layers = mod.paper_network(50, 500)
        secs.append(mod.comm_time_s(layers, 64, bandwidth_mbps=5.0))
        assert np.isclose(secs[-1], mod.upload_elements(layers, 64) * 64 / 5e6)
    assert secs[0] == secs[1]


def test_eq2_matches_measured_socket_traffic():
    """The node-aware Eq. 2 predicts the bytes the port's protocol moves
    on numpy devices (within the rounding of integer allocations), and
    the port moves exactly the JAX package's bytes."""
    from repro_torch.core.master_slave import HeteroCluster

    rng = np.random.default_rng(0)
    batch = 4
    x = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(5, 5, 3, 30)).astype(np.float32)
    measured = []
    for cls in (HeteroCluster, JaxHeteroCluster):
        cluster = cls([1.0, 1.0, 1.0], ["numpy"] * 3)
        try:
            cluster.probe_times = [1.0, 1.0, 1.0]  # equal shares
            cluster.reset_stats()
            assert cluster.conv_forward(x, w).shape == (batch, 8, 8, 30)
            measured.append(cluster.comm_bytes / 4)  # float32 payloads
        finally:
            cluster.shutdown()
    assert measured[0] == measured[1]
    predicted = costmodel.upload_elements_nodes(
        [costmodel.ConvLayerSpec(8, 3, 5, 30)], batch, np.array([1 / 3, 1 / 3]),
        broadcast_inputs=True,
    )
    assert abs(measured[0] - predicted) / predicted < 0.02


def test_predict_step_time_single_device_no_comm():
    p = [mod.predict_step_time(layers=mod.paper_network(50, 500), batch=64,
                               device_conv_times=[2.0], master_comp_time=0.5,
                               bandwidth_mbps=5.0) for mod in MODS]
    _same(p[0], p[1])
    assert p[0].comm_time == 0.0 and p[0].total == 2.5


def test_predict_step_time_balanced():
    p = [mod.predict_step_time(layers=mod.paper_network(50, 500), batch=64,
                               device_conv_times=[10.0, 20.0], master_comp_time=1.0,
                               bandwidth_mbps=1e9) for mod in MODS]
    _same(p[0], p[1])
    assert np.isclose(p[0].conv_time, 20 / 3)
    assert p[0].total < 10.0 + 1.0


# ------------------------------------------------------------- simulator


def test_paper_tables_and_speeds_are_the_jax_ones():
    assert simulator.PAPER_TABLE4_CPU == jax_simulator.PAPER_TABLE4_CPU
    assert simulator.PAPER_TABLE5_GPU == jax_simulator.PAPER_TABLE5_GPU
    assert simulator.PAPER_CPU_SPEEDS == jax_simulator.PAPER_CPU_SPEEDS
    assert simulator.PAPER_GPU_SPEEDS == jax_simulator.PAPER_GPU_SPEEDS


@pytest.mark.parametrize("key", list(jax_simulator.PAPER_TABLE4_CPU))
def test_cpu_table4_fit(key):
    """Eq. 1 + Eq. 2 reproduce Table 4 within 6% per entry, in both."""
    r = simulator.fit_paper_row(*key, simulator.PAPER_TABLE4_CPU[key], device="cpu")
    _same(r, jax_simulator.fit_paper_row(*key, jax_simulator.PAPER_TABLE4_CPU[key],
                                         device="cpu"))
    assert r["max_rel_err"] < 0.06, r


@pytest.mark.parametrize("key", list(jax_simulator.PAPER_TABLE5_GPU))
def test_gpu_table5_fit(key):
    """The GPU rows fit within 12%, in both."""
    r = simulator.fit_paper_row(*key, simulator.PAPER_TABLE5_GPU[key], device="gpu")
    _same(r, jax_simulator.fit_paper_row(*key, jax_simulator.PAPER_TABLE5_GPU[key],
                                         device="gpu"))
    assert r["max_rel_err"] < 0.12, r


def test_gpu_trend_decreasing_cpu_increasing():
    """§5.3.3: CPU speedups grow with network size, GPU speedups shrink."""
    def fits(table, device):
        return [simulator.fit_paper_row(*k, table[k], device=device)["predicted"][0]
                for k in sorted(table)]

    fits_cpu = fits(simulator.PAPER_TABLE4_CPU, "cpu")
    fits_gpu = fits(simulator.PAPER_TABLE5_GPU, "gpu")
    assert fits_cpu[-1] > fits_cpu[0]
    assert fits_gpu[-1] < fits_gpu[0]


def _spec(mod, cm, n=32, bw=5.0, seed=0):
    return mod.gaussian_cluster(
        n_nodes=n, base_conv_time=100.0, rel_speed_low=0.8, rel_speed_high=2.0,
        master_comp_time=15.0, bandwidth_mbps=bw,
        layers=cm.paper_network(500, 1500), batch=1024, seed=seed,
    )


def _curves(bw):
    """The speedup curve of the same Gaussian cluster in both packages,
    equal; returns (the port's spec, its curve)."""
    spec = _spec(simulator, costmodel, bw=bw)
    jspec = _spec(jax_simulator, jax_costmodel, bw=bw)
    _same(spec, jspec)
    curve = simulator.speedup_curve(spec)
    np.testing.assert_array_equal(curve, jax_simulator.speedup_curve(jspec))
    return spec, curve


def test_scalability_saturates():
    """Figs 9/10: speedup grows, then stabilises."""
    _, curve = _curves(1e4)
    assert curve[0] == pytest.approx(1.0)
    assert curve[3] > 2.0
    assert curve[-1] / curve[15] < 1.35


def test_amdahl_ceiling_respected():
    spec, curve = _curves(1e9)
    assert simulator.amdahl_ceiling(spec) == jax_simulator.amdahl_ceiling(
        _spec(jax_simulator, jax_costmodel, bw=1e9))
    assert np.all(curve <= simulator.amdahl_ceiling(spec) + 1e-9)


def test_slow_bandwidth_can_hurt():
    """§5.4: at low enough bandwidth distribution is slower than one
    device."""
    _, curve = _curves(0.05)
    assert curve.min() < 1.0


def test_comm_grows_with_nodes():
    spec = _spec(simulator, costmodel)
    jspec = _spec(jax_simulator, jax_costmodel)
    for n in (8, 32):
        _same(simulator.simulate(spec, n), jax_simulator.simulate(jspec, n))
    assert simulator.simulate(spec, 32).comm_time > simulator.simulate(spec, 8).comm_time


# ------------------------------------------------------- the import shim


def test_master_slave_shim_has_the_jax_import_surface():
    """Every name the JAX package's shim defines — its ``__all__`` and
    the seed-era private aliases the repo's tests and benches import —
    exists in the port's, and ``_np_probe`` still probes."""
    names = {n for n in vars(jax_master_slave) if not n.startswith("__")}
    names -= {"annotations"}
    missing = sorted(n for n in names if not hasattr(master_slave, n))
    assert not missing, missing
    assert master_slave.__all__ == jax_master_slave.__all__
    from repro_torch.core.cluster.cluster import HeteroCluster

    assert master_slave.HeteroCluster is HeteroCluster
    assert master_slave._np_probe(image_size=8, in_channels=3, kernel_size=3,
                                  num_kernels=4, batch=2, repeats=1) > 0


def test_core_lazy_exports_match_the_jax_package():
    assert set(core.__all__) == set(jax_core.__all__) - NOT_PORTED
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    assert core.paper_network is costmodel.paper_network
    assert core.HeteroCluster is master_slave.HeteroCluster
