"""The trace reading on a made-up trace: busy time with overlaps counted
once, copies apart, each kernel given to the backend call it was
launched in (by its launch's correlation id, or by its device interval
where the trace holds no launch), never by name."""
import types

import pytest
import torch

from portbench import devtrace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, t0, t1, dev=CPU, corr=0, tid=1):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: t0, duration_ns=lambda: t1 - t0,
        device_type=lambda: dev, correlation_id=lambda: corr, start_thread_id=lambda: tid)


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_summary_of_a_made_up_trace():
    ms = 1_000_000
    events = [
        _ev("pb.window", 0, 100 * ms),
        _ev("pb.step", 0, 100 * ms, tid=1),
        _ev("pb.gather", 10 * ms, 60 * ms, tid=1),
        _ev("pb.cuda.conv", 10 * ms, 30 * ms, tid=1),
        _ev("pb.cpu_shard", 5 * ms, 70 * ms, tid=2),
        # a launch inside the conv call (its range's thread id differs)
        _ev("cudaLaunchKernel", 12 * ms, 13 * ms, corr=7, tid=99),
        _ev("any_kernel_name", 14 * ms, 20 * ms, dev=CUDA, corr=7),
        # no launch in the trace: placed by its device interval
        _ev("other_name", 21 * ms, 25 * ms, dev=CUDA, corr=8),
        # a master stage's kernel, launched outside every backend call
        _ev("cudaLaunchKernel", 80 * ms, 81 * ms, corr=9, tid=1),
        _ev("conv2d_fwd_kernel", 82 * ms, 84 * ms, dev=CUDA, corr=9),
        _ev("Memcpy HtoD (Pageable -> Device)", 11 * ms, 15 * ms, dev=CUDA),
        _ev("Memset (Device)", 90 * ms, 91 * ms, dev=CUDA),
        _ev("pb.cuda.conv", 10 * ms, 30 * ms, dev=CUDA),  # the range mirrored on the card
    ]
    s = devtrace.summarize(_prof(events))
    assert s["window_s"] == pytest.approx(0.1)
    # [11, 20] + [21, 25] + [82, 84] + [90, 91] ms
    assert s["busy_s"] == pytest.approx(0.016)
    assert s["copy_s"] == pytest.approx(0.004)
    assert s["kernel_s"] == {"pb.cuda.conv": pytest.approx(0.010)}
    assert s["attributed"] == {"correlation": 1, "time": 1, "launch_outside_ranges": 1}
    # each gap labelled by every thread's innermost range at its midpoint
    assert dict(s["breakdown"]["idle_gaps"]) == {
        "cpu_shard+master_stages": pytest.approx(0.011),  # [0, 11] ms
        "cpu_shard+cuda_call": pytest.approx(0.001),      # [20, 21]
        "cpu_shard+gather_wait": pytest.approx(0.057),    # [25, 82]
        "master_stages": pytest.approx(0.015),            # [84, 90], [91, 100]
    }
    ops = s["breakdown"]["device_ops"]
    assert ops[0] == ["any_kernel_name", pytest.approx(0.006)] and len(ops) == 5
