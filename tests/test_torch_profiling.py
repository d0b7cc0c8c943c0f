"""The port's §4.1.1 probe (``repro_torch/core/profiling.py``) on the CPU:
the median of the timed runs, the slowdown rule, the JAX package's
signatures, and the refusal to fall back to the CPU when asked for the
card without one.  The card's probe (K1) runs in chip_smoke.py's
device and build phases; this file needs no card."""
import inspect

import numpy as np
import pytest
import torch

from repro.core import profiling as jax_profiling
from repro_torch.core import profiling

SMALL = dict(image_size=8, in_channels=3, kernel_size=3, num_kernels=4, batch=2)


def test_signatures_are_the_jax_packages_plus_a_device():
    for name in ("probe_conv_time", "probe_devices"):
        ours = inspect.signature(getattr(profiling, name)).parameters
        theirs = inspect.signature(getattr(jax_profiling, name)).parameters
        assert list(ours)[:len(theirs)] == list(theirs), name
        assert ours["device"].default == "cuda"
        for p in theirs:
            assert ours[p].default == theirs[p].default, (name, p)


def test_probe_returns_the_median_of_its_timed_runs(monkeypatch):
    ticks = iter([0.0, 0.5, 1.0, 1.1, 2.0, 2.3, 3.0, 3.2, 4.0, 4.9])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    got = profiling.probe_conv_time(**SMALL, repeats=5, device="cpu")
    # runs of 0.5, 0.1, 0.3, 0.2, 0.9 s: the median is 0.3
    assert got == pytest.approx(0.3)


@pytest.mark.parametrize("slowdown", [0.5, 1.0, 2.0, 3.5])
def test_slowdown_scales_only_above_one(monkeypatch, slowdown):
    ticks = iter([0.0, 0.25] * 3)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    got = profiling.probe_conv_time(**SMALL, slowdown=slowdown, device="cpu")
    assert got == pytest.approx(0.25 * max(slowdown, 1.0))


def test_probe_devices_one_time_per_device_in_order(monkeypatch):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return kw["slowdown"] * 0.01

    monkeypatch.setattr(profiling, "probe_conv_time", fake)
    got = profiling.probe_devices(3, slowdowns=[1.0, 1.5, 3.0], device="cpu")
    assert got == pytest.approx([0.01, 0.015, 0.03])
    assert [c["seed"] for c in calls] == [0, 1, 2]
    assert all(c["device"] == "cpu" and c["num_kernels"] == 100 for c in calls)


def test_real_probe_on_the_cpu_is_positive_and_slowdown_orders_devices():
    times = profiling.probe_devices(2, **SMALL, slowdowns=[1.0, 50.0], device="cpu")
    assert all(t > 0 and np.isfinite(t) for t in times)
    assert times[1] > times[0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_cuda_probe_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        profiling.probe_conv_time(**SMALL)
