"""Twin of tests/test_partitioner.py over ``repro_torch.core.partitioner``:
the Eq. 1 workload-share invariants (hypothesis property tests) and the
comm-extended Eq. 1 (compute + wire time per device).

Each reference case runs here on the same hypothesis draws (the
deterministic ``tests/_hypothesis_stub.py`` where hypothesis is absent,
as the reference does): every draw goes through the port's function and
the JAX package's, the two must agree (shares to rtol 1e-12, integer
allocations exactly), and the port's result must hold the reference
case's own property at its own tolerance.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import partitioner as jax_part
from repro_torch.core import partitioner as port_part
from repro_torch.core.partitioner import (
    allocate_kernels,
    comm_aware_allocate,
    link_aware_times,
    predicted_conv_time,
    profiles_to_shares,
    speedup,
    workload_shares,
)

times_strategy = st.lists(
    st.floats(min_value=1e-3, max_value=1e3, allow_nan=False, allow_infinity=False),
    min_size=1,
    max_size=32,
)


def _shares(times):
    """The port's Eq. 1 shares, held to the JAX package's on the same
    times."""
    s = workload_shares(times)
    np.testing.assert_allclose(s, jax_part.workload_shares(times), rtol=1e-12, atol=0)
    return s


def _alloc(num_kernels, times):
    """The port's integer allocation, equal to the JAX package's."""
    k = allocate_kernels(num_kernels, times)
    np.testing.assert_array_equal(k, jax_part.allocate_kernels(num_kernels, times))
    return k


@given(times_strategy)
def test_shares_sum_to_one(times):
    s = _shares(times)
    assert np.isclose(s.sum(), 1.0)
    assert np.all(s > 0)


@given(times_strategy)
def test_shares_inverse_monotonic(times):
    """Faster device (smaller time) never gets a smaller share."""
    s = _shares(times)
    t = np.asarray(times)
    order = np.argsort(t)
    assert np.all(np.diff(s[order]) <= 1e-12)


@given(times_strategy, st.integers(min_value=0, max_value=5000))
def test_allocation_preserves_total(times, num_kernels):
    k = _alloc(num_kernels, times)
    assert k.sum() == num_kernels
    assert np.all(k >= 0)


@given(times_strategy, st.integers(min_value=64, max_value=5000))
@settings(max_examples=50)
def test_allocation_close_to_ideal(times, num_kernels):
    """Integer allocation is within 1 kernel of the fractional ideal."""
    s = _shares(times)
    k = _alloc(num_kernels, times)
    assert np.all(np.abs(k - s * num_kernels) <= 1.0 + 1e-9)


def test_paper_example():
    """§4.1.1: devices at 10 s and 20 s -> shares (2/3, 1/3), both finish
    in 6.67 s, speedup 1.5x vs device 1 — in both packages."""
    times = [10.0, 20.0]
    s = _shares(times)
    assert np.allclose(s, [2 / 3, 1 / 3])
    k = _alloc(300, times)
    assert list(k) == [200, 100]
    t = predicted_conv_time(times, k, 300)
    assert t == jax_part.predicted_conv_time(times, k, 300)
    assert np.isclose(t, 20 / 3, rtol=1e-6)
    sp = speedup(times, k, 300)
    assert sp == jax_part.speedup(times, k, 300)
    assert np.isclose(sp, 1.5, rtol=1e-6)


@given(times_strategy)
@settings(max_examples=50)
def test_balanced_finish_times(times):
    """Under fractional Eq. 1 shares every device finishes simultaneously
    in the harmonic-aggregate time."""
    t = np.asarray(times)
    s = _shares(times)
    finish = t * s
    assert np.allclose(finish, finish[0], rtol=1e-9)
    assert np.allclose(finish[0], 1.0 / np.sum(1.0 / t), rtol=1e-9)


def test_homogeneous_fixed_point():
    """Homogeneous devices -> uniform shares."""
    s = _shares([3.7] * 8)
    assert np.allclose(s, 1 / 8)


@pytest.mark.parametrize("part", ["port", "jax"])
def test_invalid_inputs(part):
    shares, alloc = {
        "port": (workload_shares, allocate_kernels),
        "jax": (jax_part.workload_shares, jax_part.allocate_kernels),
    }[part]
    with pytest.raises(ValueError):
        shares([])
    with pytest.raises(ValueError):
        shares([1.0, -2.0])
    with pytest.raises(ValueError):
        alloc(-1, [1.0])


# ---------------------------------------------------------------------------
# the comm-extended Eq. 1: compute + wire time per device
# ---------------------------------------------------------------------------


def test_link_aware_times_adds_wire_seconds():
    """1 MB over an 8 Mbps link is exactly 1 second; None/inf links (the
    master, or unemulated sockets) add nothing."""
    args = ([1.0, 1.0, 1.0], [1e6, 1e6, 1e6], [None, 8.0, np.inf])
    t = link_aware_times(*args)
    np.testing.assert_array_equal(t, jax_part.link_aware_times(*args))
    assert t[0] == pytest.approx(1.0)
    assert t[1] == pytest.approx(2.0)
    assert t[2] == pytest.approx(1.0)
    for fn in (link_aware_times, jax_part.link_aware_times):
        with pytest.raises(ValueError):
            fn([1.0], [1e6], [-5.0])
        with pytest.raises(ValueError):
            fn([1.0, 1.0], [1e6], [None, 8.0])


def test_comm_aware_allocate_penalizes_slow_links():
    """Equal compute, one slow link: the comm-extended Eq. 1 hands the
    slow-linked device fewer units than the plain compute split."""
    plain = _alloc(30, [1.0, 1.0, 1.0])
    args = (30, [1.0, 1.0, 1.0], [0.0, 1e6, 1e6], [None, 100.0, 5.0])
    comm = comm_aware_allocate(*args)
    np.testing.assert_array_equal(comm, jax_part.comm_aware_allocate(*args))
    assert plain.tolist() == [10, 10, 10]
    assert comm.sum() == 30
    assert comm[2] < comm[1] <= comm[0]


def test_profiles_to_shares_weighs_measured_links():
    """With wire_bytes the probed shares include each profile's link —
    the device behind the paper's ~5 Mbps Wi-Fi loses share to the
    wired one even at identical compute."""
    def profs(mod):
        return [
            mod.DeviceProfile("master", 1.0),
            mod.DeviceProfile("wired", 1.0, bandwidth_mbps=1000.0),
            mod.DeviceProfile("wifi", 1.0, bandwidth_mbps=5.0),
        ]

    plain = profiles_to_shares(profs(port_part))
    comm = profiles_to_shares(profs(port_part), wire_bytes=[0.0, 1e6, 1e6])
    np.testing.assert_allclose(plain, jax_part.profiles_to_shares(profs(jax_part)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        comm, jax_part.profiles_to_shares(profs(jax_part), wire_bytes=[0.0, 1e6, 1e6]),
        rtol=1e-12)
    assert np.allclose(plain, 1 / 3)
    assert comm[2] < comm[1] <= comm[0]
    assert np.isclose(comm.sum(), 1.0)
