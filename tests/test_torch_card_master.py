"""The master's shard on its own device (the card path): where the
cluster's master computes on the step's device, ``make_cluster_train_step``
hands the cluster tensors there, and only the slaves' slices cross to
the host.  On the CPU (a ``torch:cpu`` master, or ``CudaBackend`` on CPU
tensors, the kernels' plain versions) three steps on the card path are
bitwise equal to the host path's (the same cluster with its master
handed numpy) from the same params and batches: one device; a numpy
slave with kernels; a master and a slave without kernels; the reduced
VGG-16 chain with dropout; the spatial and batch axes, which run their
host path inside.  The seam's own contract; the readers
``master_card_call_share.train`` and ``seam_copy_mb_per_step.train`` on
synthetic spans and in tiny traced runs of the benchmark's cells."""
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.vgg16 import make_vgg16_config
from repro_torch.core import spans
from repro_torch.core.backends import CudaBackend, get_backend, register_backend, seam
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.models.cnn import (
    init_chain,
    init_cnn,
    make_cluster_train_step,
    make_cnn_config,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as pb_run, spec as pb_spec  # noqa: E402

STEPS, BATCH, LR = 3, 4, 0.05
CNN = make_cnn_config(4, 8)
VGG = make_vgg16_config(16, 32)  # tests/test_torch_vgg16.py's SMALL


@register_backend("cuda_on_cpu")
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
    spans.record("test.off", time.perf_counter(), time.perf_counter())


def _batches(size, classes, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, size, size, 3), dtype=np.float32),
             rng.integers(0, classes, BATCH).astype(np.int32)) for _ in range(STEPS)]


def _steps(backends, times, *, card, cfg=CNN, partition="kernel"):
    """Three steps from seed-0 params over a cluster with pinned probe
    times and no comp-aware discount (the same split on both paths):
    (losses, params as numpy, the spans and counters of the traced third
    step).  The
    host path hands the same master numpy (its device unknown to the
    step)."""
    chain = cfg is not CNN
    params = (init_chain if chain else init_cnn)(torch.Generator().manual_seed(0), cfg)
    c = HeteroCluster([1.0] * len(backends), backends, pipeline=True, microbatches=2,
                      comp_aware=False, partition=partition)
    try:
        c.probe_times = list(times)
        if not card:
            c.master_device = None
        step = make_cluster_train_step(c, cfg, lr=LR, device="cpu", dropout_seed=11)
        losses = []
        for i, (x, y) in enumerate(_batches(cfg.image_size, 1000 if chain else 10)):
            if i == STEPS - 1:
                _off_boundary()
                with _profiler():
                    params, loss, _ = step(params, x, y)
            else:
                params, loss, _ = step(params, x, y)
            losses.append(loss)
    finally:
        c.shutdown()
    host = {f"{l}.{n}": v.detach().numpy().copy() for l, d in params.items()
            for n, v in d.items()}
    return losses, host, (spans.spans(), spans.counters())


def _assert_paths_agree(backends, times, **kw):
    """The card path's and the host path's traced spans and counters."""
    card_losses, card_params, card_spans = _steps(backends, times, card=True, **kw)
    host_losses, host_params, host_spans = _steps(backends, times, card=False, **kw)
    assert card_losses == host_losses
    assert card_params.keys() == host_params.keys()
    for k in card_params:
        assert np.array_equal(card_params[k], host_params[k]), k
    return card_spans, host_spans


def _names(traced):
    return {s.name for s in traced[0]}


def _labels(traced, name):
    return {s.attrs["operands"] for s in traced[0] if s.name == name}


@pytest.mark.parametrize("backends, times", [
    (["torch:cpu"], [1.0]),
    (["torch:cpu", "numpy"], [1.0, 2.0]),
    (["cuda_on_cpu", "numpy"], [1.0, 2.0]),
], ids=["alone", "numpy_slave", "cuda_backend"])
def test_the_card_path_equals_the_host_path_bitwise(backends, times):
    card, host = _assert_paths_agree(backends, times)
    assert _labels(card, "cluster.master_shard") == {"card"}
    assert _labels(host, "cluster.master_shard") == {"host"}
    # the kernels and the activations stay on the master's device
    assert not _names(card) & {"step.kernels_to_host", "step.kernels_to_card",
                               "step.to_host"}
    assert {"step.kernels_to_host", "step.kernels_to_card", "step.to_host"} <= _names(host)
    assert ("cluster.to_host" in _names(card)) == (len(backends) > 1)
    if backends[0] == "cuda_on_cpu":
        assert _labels(card, "cuda.compute") == {"card"}
        assert _labels(host, "cuda.compute") == {"host"}
        assert not _names(card) & {"cuda.to_card", "cuda.to_host"}


@pytest.mark.parametrize("times, idle", [([1.0, 1e9], "slave"), ([1e9, 1.0], "master")])
def test_a_shard_without_kernels_on_either_side(times, idle):
    card, _ = _assert_paths_agree(["torch:cpu", "numpy"], times)
    assert _labels(card, "cluster.master_shard") == {"card"}
    if idle == "slave":
        # no slave holds kernels: nothing of the master's crosses to it
        assert "cluster.to_host" not in card[1]
        assert card[1]["cluster.to_card"].bytes_by.keys() == {"dx"}
    else:
        assert card[1]["cluster.to_host"].bytes_by.keys() == {"x", "g", "w"}
        assert card[1]["cluster.to_card"].bytes_by.keys() == {"y", "dx", "dw"}


def test_the_reduced_vgg16_chain_with_dropout():
    card, host = _assert_paths_agree(["torch:cpu", "numpy"], [1.0, 2.0], cfg=VGG)
    assert _labels(card, "cluster.master_shard") == {"card"}
    assert "step.masks" in _names(card) and "step.masks" in _names(host)


@pytest.mark.parametrize("partition", ["spatial", "batch"])
def test_the_spatial_and_batch_axes_convert_at_their_boundary(partition):
    card, _ = _assert_paths_agree(["torch:cpu", "numpy"], [1.0, 2.0], partition=partition)
    # the host path inside: the master computes on numpy, and its
    # operands cross at the axis' boundary
    assert _labels(card, "cluster.master_shard") == {"host"}
    assert {"cluster.to_host", "cluster.to_card"} <= _names(card)
    assert not _names(card) & {"step.kernels_to_host", "step.to_host"}


def test_a_lost_slave_s_shard_is_recomputed_on_the_master_s_device():
    """The recovery path on card operands: what the master computes for
    a slave lost between scatter and gather lies on its device and is
    that slave's share; the backward reuses the forward's host copy."""
    rng = np.random.default_rng(3)
    x, w, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((2, 8, 8, 3), (3, 3, 3, 6), (2, 8, 8, 6)))
    c = HeteroCluster([1.0, 1.0], ["torch:cpu", "numpy"], comp_aware=False)
    try:
        c.probe_times = [1.0, 1.0]
        plan = c.plan_conv(tuple(x.shape), w, "train")
        p = c._scatter_conv_planned(x, plan, True)
        y = c.gather_conv(p)
        q = c._scatter_bwd_planned(x, plan, g, True, x_host=p.x_host)
        dx, dw = c.gather_bwd(q)
        y1, (dx1, dw1) = c._recover_shard(p, 1), c._recover_shard(q, 1)
    finally:
        c.shutdown()
    assert q.x_host is p.x_host and isinstance(p.x_host, np.ndarray)
    assert all(isinstance(t, torch.Tensor) for t in (y, dx, dw, y1, dx1, dw1))
    c0 = int(plan.counts[0])
    assert 0 < c0 < 6
    dx0, _ = get_backend("torch:cpu").conv_vjp(x, w[..., :c0].contiguous(),
                                               g[..., :c0].contiguous())
    torch.testing.assert_close(y1, y[..., c0:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw1, dw[..., c0:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx0 + dx1, dx, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the seam


def test_the_seam_moves_only_what_is_elsewhere_and_records_those_bytes():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.ones(4)
    _off_boundary()
    with _profiler():
        got_a, got_t = seam(torch.device("cpu"), "test.to_card", a=a, t=t)
        back = seam(None, "test.to_host", y=got_a)
        same = seam(None, "test.to_host", a=a)
        empty = seam(None, "test.to_host", e=torch.ones((2, 0)))
    assert got_t is t and same is a
    assert isinstance(got_a, torch.Tensor) and torch.equal(got_a, torch.from_numpy(a))
    assert isinstance(back, np.ndarray) and np.array_equal(back, a)
    assert isinstance(empty, np.ndarray) and empty.shape == (2, 0)
    c = spans.counters()
    assert c["test.to_card"].bytes_by == {"a": 24} and c["test.to_card"].count == 1
    assert c["test.to_host"].bytes_by == {"y": 24} and c["test.to_host"].count == 1


def test_backends_keep_numpy_numpy_and_tensors_tensors():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    g = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    for name in ("torch:cpu", "cuda_on_cpu"):
        b = get_backend(name)
        assert b.device == torch.device("cpu")
        y = b.conv(x, w)
        dx, dw = b.conv_vjp(x, w, g)
        ty = b.conv(torch.from_numpy(x), torch.from_numpy(w))
        tdx, tdw = b.conv_vjp(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
        assert all(isinstance(a, np.ndarray) for a in (y, dx, dw))
        assert all(isinstance(a, torch.Tensor) for a in (ty, tdx, tdw))
        for a, t in ((y, ty), (dx, tdx), (dw, tdw)):
            assert np.array_equal(a, t.numpy())
    assert get_backend("numpy").device is None


# ------------------------------------------------------------- the readers

SHARE, SEAM = "master_card_call_share.train", "seam_copy_mb_per_step.train"


def _recorded(*recs):
    """A profiler session holding the spans ``(name, nbytes, attrs)``."""
    _off_boundary()
    with _profiler():
        t = time.perf_counter()
        spans.record("step", t, t + 1.0)
        for name, nbytes, attrs in recs:
            spans.record(name, t, t + 1e-6, nbytes, **attrs)


def _run(steps=2):
    return pb_run.Run("cell", {}, {}, 1.0, {"steps": steps, "images": 8 * steps})


def test_the_call_share_reads_cuda_compute_first():
    _recorded(*[("cuda.compute", None, {"operands": "card"})] * 3,
              ("cuda.compute", None, {"operands": "host"}),
              *[("cluster.master_shard", None, {"operands": "host"})] * 5)
    assert pb_spec.reader(SHARE).read(_run()) == pytest.approx(75.0)


def test_the_call_share_reads_the_master_shard_where_no_cuda_call_ran():
    _recorded(("cluster.master_shard", None, {"operands": "card"}),
              ("cluster.master_shard", None, {"operands": "host"}))
    assert pb_spec.reader(SHARE).read(_run()) == pytest.approx(50.0)


def test_the_seam_reads_both_directions_per_step():
    _recorded(("cluster.master_shard", None, {"operands": "card"}),
              ("cluster.to_host", {"x": 3_000_000, "w": 1_000_000}, {}),
              ("cluster.to_card", {"y": 2_000_000}, {}))
    assert pb_spec.reader(SEAM).read(_run(steps=2)) == pytest.approx(3.0)
    _recorded(("cluster.master_shard", None, {"operands": "card"}))
    assert pb_spec.reader(SEAM).read(_run()) == 0.0


def test_nothing_is_read_from_a_program_without_the_labels():
    _recorded(("cuda.compute", None, {}), ("cluster.master_shard", None, {}),
              ("cluster.to_host", 4_000_000, {}))
    assert pb_spec.reader(SHARE).read(_run()) is None
    assert pb_spec.reader(SEAM).read(_run()) is None


def _tiny(name):
    """The cell at C1 4, C2 8, batch 4 in 2 microbatches (portbench's
    own tests' cut)."""
    s = pb_spec.load(name)
    s.cfg = dict(s.cfg, c1_kernels=4, c2_kernels=8)
    s.cell = dict(s.cell, batch=4, microbatches=2)
    return s


@pytest.mark.parametrize("cell", ["cnn500_train_hetero", "cnn500_train_gpu"])
def test_a_traced_run_reads_the_card_path(cell):
    result, _ = pb_run.run_cell(_tiny(cell), 2 ** 31 + 77, 1.0, True, device="cpu",
                                backend_map={"cuda": "torch:cpu"})
    assert result["correct"] is True
    got = {k: m["value"] for k, m in result["metrics"].items()}
    assert got[SHARE] == 100.0
    if cell == "cnn500_train_gpu":
        assert got[SEAM] == 0.0
    else:
        assert got[SEAM] > 0.0
