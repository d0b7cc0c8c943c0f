"""The port's own spans and counters (``repro_torch.core.spans``): they
are recorded only while a torch profiler records, on every thread, on
the profiler's host clock and never as profiler events; a session starts
from empty counters; the deque keeps its cap while the counters count
every span.  A tiny training step beside a ``numpy`` device records
every boundary's span, as often as the schedule crosses it, and agrees
with ``LayerTiming``: over a ``numpy`` master (the host path: every
operand numpy) and over a ``torch:cpu`` master (the card path: the
master's operands stay tensors on the step's device, and only the
slave's slices cross the seam); ``CudaBackend`` (here on CPU tensors,
the kernels' plain versions) keeps its copies apart from its compute."""
import collections
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import spans
from repro_torch.core.backends import CudaBackend
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.models.cnn import init_cnn, make_cluster_train_step, make_cnn_config

MICRO, LAYERS, STEPS = 2, 2, 2
CONVS = MICRO * LAYERS * 2  # a conv op per microbatch, layer and direction
STAGES = 2 * MICRO * LAYERS + MICRO  # the between stages both ways, the head
BOTH = {
    "step": 1,
    "step.update_host": 1,
    "step.head": MICRO,
    "cluster.plan": LAYERS,
    "cluster.scatter": CONVS,
    "cluster.master_shard": CONVS,
    "cluster.gather_wait": CONVS,
    "cluster.master_stage": STAGES,
    "device.shard": CONVS,
}
PER_STEP = {
    "host": dict(BOTH, **{
        "step.kernels_to_host": LAYERS,
        "step.kernels_to_card": LAYERS,
        "step.to_card": STAGES,
        "step.to_host": STAGES,
    }),
    "card": dict(BOTH, **{
        "step.to_card": 1,  # the images
        # each layer's input a microbatch, the slave's gradient slice a
        # backward op, its kernel shard a layer (the backward's a token)
        "cluster.to_host": 2 * LAYERS * MICRO + LAYERS,
        "cluster.to_card": CONVS,  # the slave's y, or its dx and dw
    }),
}
NAMES = sorted(set(PER_STEP["host"]) | set(PER_STEP["card"]))
# the card path's split (pinned times, no comp-aware discount): half of
# each layer's kernels on the slave
SLAVE_KERNELS = (2, 4)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _off_boundary():
    """A boundary passed while no profiler records (it ends a session)."""
    spans.record("test.off", time.perf_counter(), time.perf_counter())


@pytest.fixture(scope="module", params=["host", "card"])
def traced_step(request):
    """Two steps of the paper's CNN at C1 4, C2 8, batch 4 in 2
    microbatches, under a profiler, after one step outside it: over a
    numpy master (the host path, shares by the probe) or a torch:cpu one
    on the step's device (the card path, shares by pinned times)."""
    path = request.param
    cfg = make_cnn_config(4, 8)
    cluster = HeteroCluster([1.0, 1.0], ["numpy" if path == "host" else "torch:cpu", "numpy"],
                            pipeline=True, microbatches=MICRO, comp_aware=path == "host")
    try:
        if path == "host":
            cluster.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=8,
                          batch=4)
        else:
            cluster.probe_times = [1.0, 1.0]
        params = init_cnn(torch.Generator().manual_seed(0), cfg)
        step = make_cluster_train_step(cluster, cfg, lr=0.01, device="cpu")
        x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
        labels = np.arange(4) % 10
        params, _, _ = step(params, x, labels)
        before = dict(vars(cluster.timing))
        with _profiler() as prof:
            for _ in range(STEPS):
                params, _, _ = step(params, x, labels)
        after = dict(vars(cluster.timing))
    finally:
        cluster.shutdown()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return {"spans": spans.spans(), "counters": spans.counters(), "kineto": names,
            "timing": {k: after[k] - before[k] for k in after},
            "main": threading.get_native_id(), "path": path, "per_step": PER_STEP[path]}


def test_nothing_is_recorded_outside_a_profiler():
    _off_boundary()
    with _profiler():
        spans.record("test.inside", time.perf_counter(), time.perf_counter())
    before_spans, before_counters = spans.spans(), spans.counters()
    assert not spans.recording()
    t = time.perf_counter()
    spans.record("test.outside", t, t + 1.0, nbytes=8, label="x")
    with spans.span("test.outside", 8):
        pass
    spans.count("test.outside", 3)
    assert spans.spans() == before_spans
    assert spans.counters() == before_counters
    assert [s.name for s in before_spans] == ["test.inside"]


def _worker_span():
    with spans.span("test.worker"):
        pass


def test_spans_are_recorded_on_the_main_thread_and_a_thread_started_inside():
    _off_boundary()
    with _profiler():
        with spans.span("test.main"):
            pass
        th = threading.Thread(target=_worker_span)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    got = {s.name: s.thread for s in spans.spans()}
    assert set(got) == {"test.main", "test.worker"}
    assert got["test.main"] == threading.get_native_id() != got["test.worker"]


def test_a_span_lies_within_the_profiler_range_around_it_on_its_clock():
    _off_boundary()
    with _profiler() as prof:
        with record_function("test_outer"):
            with spans.span("test.inner"):
                time.sleep(0.02)
    (inner,) = spans.spans()
    (outer,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "test_outer"]
    ms = 1_000_000
    assert outer.start_ns() - ms <= inner.start_ns < inner.end_ns <= (
        outer.start_ns() + outer.duration_ns() + ms)
    assert inner.end_ns - inner.start_ns >= 20 * ms - ms


def test_a_second_session_starts_from_empty_counters():
    _off_boundary()
    with _profiler():
        spans.record("test.first", time.perf_counter(), time.perf_counter(), nbytes=4)
        spans.count("test.events", 2)
    assert spans.counters()["test.events"].count == 2
    _off_boundary()
    with _profiler():
        spans.record("test.second", time.perf_counter(), time.perf_counter())
    assert set(spans.counters()) == {"test.second"}
    assert [s.name for s in spans.spans()] == ["test.second"]


def test_the_deque_holds_its_cap_while_the_counters_count_every_span():
    _off_boundary()
    n = spans.CAP + 100
    with _profiler():
        t = time.perf_counter()
        for i in range(n):
            spans.record("test.many", t + i * 1e-6, t + (i + 1) * 1e-6, nbytes=2)
    kept = spans.spans()
    c = spans.counters()["test.many"]
    assert len(kept) == spans.CAP and c.count == n and c.bytes == 2 * n
    # the oldest are dropped: the last kept is the last recorded
    assert kept[-1].end_ns - kept[0].start_ns == pytest.approx(spans.CAP * 1000, abs=2)


@pytest.mark.parametrize("name", NAMES)
def test_a_step_records_each_boundary_as_often_as_the_schedule_crosses_it(traced_step, name):
    got = [s for s in traced_step["spans"] if s.name == name]
    per_step = traced_step["per_step"]
    if name not in per_step:  # a boundary the other path crosses
        assert not got and name not in traced_step["counters"]
        return
    by_step = collections.Counter(s.step for s in got)
    assert by_step == {k: per_step[name] for k in range(STEPS)}
    assert traced_step["counters"][name].count == STEPS * per_step[name]
    threads = {s.thread for s in got}
    if name == "device.shard":
        assert traced_step["main"] not in threads and len(threads) == 1
        assert {(s.attrs["device"], s.attrs["backend"]) for s in got} == {(1, "numpy")}
        assert collections.Counter(s.attrs["op"] for s in got) == {
            "conv": STEPS * CONVS // 2, "bwd": STEPS * CONVS // 2}
    else:
        assert threads == {traced_step["main"]}


def test_a_step_records_no_other_names_and_moves_bytes_where_it_copies(traced_step):
    c = traced_step["counters"]
    assert set(c) == set(traced_step["per_step"])
    moved = {n for n, v in c.items() if v.bytes}
    if traced_step["path"] == "host":
        assert moved == {"step.kernels_to_host", "step.kernels_to_card", "step.to_card",
                         "step.to_host", "step.head"}
        # both conv kernels, each way, every step: 5x5x3x4 and 5x5x4x8 floats
        assert c["step.kernels_to_host"].bytes == c["step.kernels_to_card"].bytes == (
            STEPS * 4 * (5 * 5 * 3 * 4 + 5 * 5 * 4 * 8))
        return
    assert moved == {"step.to_card", "step.head", "cluster.to_host", "cluster.to_card"}
    assert c["step.to_card"].bytes_by == {"images": STEPS * 4 * 4 * 32 * 32 * 3}
    # a microbatch of 2: each layer's input (32x32x3, 16x16x4) out and
    # its dX back; the slave's channels of y back and of g out; its
    # kernel shard out once a step, its dW back every backward op
    x = STEPS * MICRO * 4 * 2 * (32 * 32 * 3 + 16 * 16 * 4)
    y = STEPS * MICRO * 4 * 2 * (32 * 32 * SLAVE_KERNELS[0] + 16 * 16 * SLAVE_KERNELS[1])
    w = 4 * (5 * 5 * 3 * SLAVE_KERNELS[0] + 5 * 5 * 4 * SLAVE_KERNELS[1])
    assert c["cluster.to_host"].bytes_by == {"x": x, "g": y, "w": STEPS * w}
    assert c["cluster.to_card"].bytes_by == {"y": y, "dx": x, "dw": STEPS * MICRO * w}


def test_the_master_shard_names_where_its_operands_lie(traced_step):
    got = {s.attrs["operands"] for s in traced_step["spans"] if s.name == "cluster.master_shard"}
    assert got == {traced_step["path"]}


@pytest.mark.parametrize("field, name", [("gather_wait_s", "cluster.gather_wait"),
                                         ("master_conv_s", "cluster.master_shard"),
                                         ("comp_s", "cluster.master_stage")])
def test_layer_timing_and_the_spans_share_their_clock_reads(traced_step, field, name):
    assert traced_step["timing"][field] > 0
    assert traced_step["counters"][name].s == pytest.approx(traced_step["timing"][field],
                                                            rel=0, abs=1e-9)
    summed = sum(s.end_ns - s.start_ns for s in traced_step["spans"] if s.name == name)
    assert summed / 1e9 == pytest.approx(traced_step["timing"][field],
                                         abs=1e-9 * (1 + STEPS * traced_step["per_step"][name]))


def test_every_child_span_lies_inside_its_parent(traced_step):
    sp = traced_step["spans"]
    parents = collections.Counter()
    for s in sp:
        if s.parent is None:
            continue
        p = sp[s.parent]
        assert p.thread == s.thread and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        parents[s.name, p.name] += 1
    per_step = traced_step["per_step"]
    if traced_step["path"] == "host":
        # the copies of the stages inside the stages, the rest of the master's inside the step
        assert parents["step.to_card", "cluster.master_stage"] == STEPS * STAGES
        inside_step = ("step.kernels_to_host",)
    else:
        # the images inside the step, the slave's inputs inside the scatters, its
        # results' moves after the gather wait
        assert parents["cluster.to_host", "cluster.scatter"] == STEPS * per_step["cluster.to_host"]
        inside_step = ("step.to_card", "cluster.to_card")
    assert parents["step.head", "cluster.master_stage"] == STEPS * MICRO
    for name in ("cluster.plan", "cluster.scatter", "cluster.master_shard",
                 "cluster.gather_wait",
                 "cluster.master_stage", "step.update_host") + inside_step:
        assert parents[name, "step"] == STEPS * per_step[name]
    # a span on another thread never has a parent on the master's
    assert all(s.parent is None for s in sp if s.name in ("step", "device.shard"))


def test_no_program_span_is_a_profiler_event(traced_step):
    assert not traced_step["kineto"] & set(NAMES)
    assert not traced_step["kineto"] & {"cuda.to_card", "cuda.compute", "cuda.to_host",
                                        "cluster.recover"}


def test_cuda_backend_keeps_its_copies_apart_from_its_compute():
    backend = CudaBackend.__new__(CudaBackend)  # the kernels' plain versions on the CPU
    backend.device = torch.device("cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    g = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    _off_boundary()
    with _profiler():
        y = backend.conv(x, w)
        dx, dw = backend.conv_vjp(x, w, g)
    c = spans.counters()
    assert [s.name for s in spans.spans()] == ["cuda.to_card", "cuda.compute", "cuda.to_host"] * 2
    assert c["cuda.to_card"].bytes_by == {"x": 2 * x.nbytes, "w": 2 * w.nbytes, "g": g.nbytes}
    assert c["cuda.to_host"].bytes_by == {"y": y.nbytes, "dx": dx.nbytes, "dw": dw.nbytes}
    assert c["cuda.compute"].bytes == 0 and c["cuda.compute"].count == 2
