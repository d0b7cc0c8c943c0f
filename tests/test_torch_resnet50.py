"""ResNet-50 (arXiv:1512.03385, Table 1) through the port's one training
step, ``make_cluster_train_step``, held on the CPU against the plain
float64 reference (``tests/_resnet50_reference.py``) at a small size:
the full depth (3, 4, 6, 3 blocks) with every width divided by 16, on
64x64 inputs, batch 8 in 4 microbatches (batch norm over 2 rows).  The
step on ``torch:cpu`` and ``numpy,torch:cpu`` clusters (the kernel
axis, pipelined): the loss and every parameter after 2 steps; the
strides on stride-1 convs and batch norm against ``F.conv2d`` and
``F.batch_norm``, forward and gradients; a step whose stage drops the
shortcut's gradient caught; the spans ``step.norm`` and
``step.shortcut``; the launcher's ``--arch resnet50``."""
import collections
import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(__file__))

import _resnet50_reference as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.resnet50 import SGD_LR, make_resnet50_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.cluster.cluster import HeteroCluster  # noqa: E402
from repro_torch.kernels.ref import conv2d_dw_ref, conv2d_dx_ref, conv2d_ref  # noqa: E402
from repro_torch.launch import hetero  # noqa: E402
from repro_torch.layers.norm import batch_norm, batch_norm_bwd, batch_norm_fwd  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models.cnn import DENSE_INIT_STD, make_cluster_train_step  # noqa: E402
from repro_torch.models.resnet import (  # noqa: E402
    init_resnet,
    resnet_layers,
    resnet_param_count,
    subsample,
    subsample_vjp,
)

DIV, SIZE, BATCH, MICRO, LR = 16, 64, 8, 4, SGD_LR
SMALL = make_resnet50_config(DIV, SIZE)
# the reference's own description of the same network
REF_CFG = {"stem_width": 64 // DIV, "stem_kernel": 7, "expansion": 4, "num_classes": 1000,
           "bn_eps": 1e-5,
           "stages": [{"width": w // DIV, "blocks": n, "stride": s}
                      for w, n, s in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: the small network's some 2,000
    ops a step gain nothing from more, and slow a hundredfold where the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal((BATCH, SIZE, SIZE, 3), dtype=np.float32),
             "labels": rng.integers(0, 1000, BATCH).astype(np.int32)} for _ in range(n)]


def _host(params):
    return {l: {n: t.detach().cpu().numpy().astype(np.float64) for n, t in d.items()}
            for l, d in params.items()}


def _train(backends, batches, microbatches=MICRO):
    """``make_cluster_train_step``'s steps from ``init_resnet``'s seed-0
    params: (params before, loss, params after) of each, numpy."""
    params = init_resnet(torch.Generator().manual_seed(0), SMALL)
    steps = []
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True,
                            microbatches=microbatches)
    try:
        cluster.probe(image_size=SIZE, in_channels=3, kernel_size=7, num_kernels=8,
                      batch=BATCH)
        step = make_cluster_train_step(cluster, SMALL, lr=LR, device="cpu")
        for b in batches:
            before = _host(params)
            params, loss, _ = step(params, b["images"], b["labels"])
            steps.append((before, loss, _host(params)))
    finally:
        cluster.shutdown()
    return steps


# Tolerances.  The program computes in float32, the reference in
# float64.  A step's loss agrees to a few float32 ulps: LOSS_RTOL (the
# readings are 2e-8 to 2.6e-7).  Its gradients do not, at this size:
# batch norm over 2 to 8 rows, down to 8 values a channel in the last
# stage, lets one ReLU or max-pool flip near a tie move them, and a
# float32 rounding of the images (1e-7 relative) moves the float64
# reference's own first gradient by 2% (by norm, over every leaf) on one
# seed tried, its second by 23% for the median leaf once the first
# step's params move by 1e-6 of themselves.  So each step is held
# locally, from the program's own params before it, as the card's runs
# hold the cluster's steps, by what a flip moves least.  Over 48 such
# steps (seeds 1-8, 1, 2 and 4 microbatches, one torch thread) the
# gradient each took (its change over lr) read at most 0.10 from the
# reference's by norm over every leaf, 0.055 for the median leaf and
# 0.36 for the worst leaf; a step that drops the shortcut's gradient
# reads 0.99-1.00, 0.98-1.00 and 1.0 on some 130 leaves, the TF32
# control 0.57-1.06 and 0.47-1.00, and a leaf left without its gradient
# reads 1.0.  GRAD_RTOL (every leaf), MEDIAN_RTOL and LEAF_RTOL lie
# between, 2.5, 2.7 and 2.1 times above the program's worst.
LOSS_RTOL, GRAD_RTOL, MEDIAN_RTOL, LEAF_RTOL = 2e-6, 0.25, 0.15, 0.75


def _gaps(before, after, want):
    """The gradient each step took, (before - after) / lr, against the
    reference's, (before - want) / lr: (the whole gradient's relative
    gap, each leaf's)."""
    got = {(l, n): (v - after[l][n]) / LR for l, d in before.items() for n, v in d.items()}
    ref_g = {(l, n): (v - want[l][n]) / LR for l, d in before.items() for n, v in d.items()}
    # a leaf without a gradient in both (a dropped shortcut's projection) reads 0
    leaf = {k: np.linalg.norm(got[k] - ref_g[k]) / (np.linalg.norm(ref_g[k]) or 1.0)
            for k in got}
    num = math.sqrt(sum(float(np.sum((got[k] - ref_g[k]) ** 2)) for k in got))
    den = math.sqrt(sum(float(np.sum(ref_g[k] ** 2)) for k in got))
    return num / den, leaf


def _held(steps, batches, group, **fault):
    """Each step of ``steps`` ((params before, loss, params after) by
    ``_train``) against one reference step from the same params: the
    leaves off by more than the tolerances, or [] where it holds."""
    bad = []
    for (before, loss, after), b in zip(steps, batches):
        want_loss, want, _ = ref.sgd_steps(before, [b], LR, REF_CFG, "cpu", group, **fault)
        whole, leaf = _gaps(before, after, want)
        if abs(loss - want_loss[0]) > LOSS_RTOL * abs(want_loss[0]):
            bad.append("loss")
        if whole > GRAD_RTOL:
            bad.append("gradient")
        if np.median(list(leaf.values())) > MEDIAN_RTOL:
            bad.append("median leaf")
        bad += [k for k, v in leaf.items() if v > LEAF_RTOL]
    return bad


def test_resnet50_is_table_1_fifty_layers():
    cfg = get_config("resnet50")
    assert cfg == make_resnet50_config() and cfg.arch_id == "resnet50"
    assert [(s.width, s.blocks, s.stride) for s in cfg.stages] == [
        (64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    assert (cfg.stem_width, cfg.stem_kernel, cfg.expansion, cfg.num_classes) == (
        64, 7, 4, 1000)
    assert (cfg.image_size, cfg.image_channels, cfg.bn_eps, cfg.dtype) == (
        224, 3, 1e-5, "float32")
    layers = resnet_layers(cfg)
    assert len(layers) == 53 and sum(l.role == "proj" for l in layers) == 4
    assert sum(l.kernel_size == 1 for l in layers) == 36
    # the stride on the first 1x1 and the projection of conv3_1 .. conv5_1
    assert [l.name for l in layers if l.stride == 2] == [
        "conv1", "res3a_branch1", "res3a_branch2a", "res4a_branch1", "res4a_branch2a",
        "res5a_branch1", "res5a_branch2a"]
    assert resnet_param_count(cfg) == 25_557_032
    # 3.86 G multiply-adds a forward at the published strides
    h, macs = 56, 112 * 112 * 49 * 3 * 64
    for l in layers[1:]:
        out = h // 2 if l.stride == 2 else h
        macs += out * out * l.kernel_size ** 2 * l.cin * l.cout
        h = out if l.role in ("a", "b", "c") else h
    macs += 2048 * 1000
    assert macs == 3_857_973_248


def test_init_resnet_draws_he_normal_convs_unit_bn_and_a_0_01_head():
    params = init_resnet(torch.Generator().manual_seed(0), SMALL)
    names = [n for l in resnet_layers(SMALL) for n in (l.name, l.bn)] + ["fc1000"]
    assert list(params) == names
    assert params["conv1"]["kernel"].shape == (7, 7, 3, 4)
    assert params["res5c_branch2c"]["kernel"].shape == (1, 1, 32, 128)
    assert params["fc1000"]["kernel"].shape == (128, 1000)
    w = params["res4a_branch2b"]["kernel"]
    assert float(w.std()) == pytest.approx(math.sqrt(2.0 / (9 * 16)), rel=0.1)
    assert float(params["fc1000"]["kernel"].std()) == pytest.approx(DENSE_INIT_STD, rel=0.05)
    assert set(params["bn2a_branch1"]) == {"gamma", "beta"}
    assert set(params["res2a_branch1"]) == {"kernel"}
    for l in resnet_layers(SMALL):
        assert torch.equal(params[l.bn]["gamma"], torch.ones(l.cout))
        assert not params[l.bn]["beta"].any()
    assert not params["fc1000"]["bias"].any()


@pytest.mark.parametrize("backends", [["torch:cpu"], ["numpy", "torch:cpu"]])
def test_the_step_matches_the_reference(backends):
    batches = _batches(2)
    assert _held(_train(backends, batches), batches, BATCH // MICRO) == []


@pytest.mark.parametrize("microbatches", [1, 2])
def test_batch_norm_takes_each_microbatch_s_statistics(microbatches):
    batches = _batches(2, seed=5)
    steps = _train(["torch:cpu"], batches, microbatches=microbatches)
    assert _held(steps, batches, BATCH // microbatches) == []


def test_a_stage_that_drops_the_shortcut_s_gradient_fails(monkeypatch):
    real = resnet.stage_vjp

    def dropping(layer, sub_out, saved, g, bn):
        gy, dgamma, dbeta, g_sc = real(layer, sub_out, saved, g, bn)
        return gy, dgamma, dbeta, None if g_sc is None else torch.zeros_like(g_sc)

    monkeypatch.setattr(resnet, "stage_vjp", dropping)
    batches = _batches(2)
    steps = _train(["torch:cpu"], batches)
    bad = _held(steps, batches, BATCH // MICRO)
    assert "gradient" in bad and "median leaf" in bad and len(bad) > 100
    # and it is the reference's own fault of that name
    assert _held(steps, batches, BATCH // MICRO, drop_shortcut=True) == []


def test_the_tf32_control_is_further_from_the_reference_than_the_step():
    batches = _batches(1)
    [(p0, _, p1)] = _train(["torch:cpu"], batches)
    group = BATCH // MICRO
    _, want, _ = ref.sgd_steps(p0, batches, LR, REF_CFG, "cpu", group)
    _, tf32, _ = ref.sgd_steps(p0, batches, LR, REF_CFG, "cpu", group, tf32=True)
    assert 3 * _gaps(p0, p1, want)[0] < _gaps(p0, tf32, want)[0]


def _grads(fn, x, w, g):
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    return torch.autograd.grad(fn(x, w), (x, w), g)


def _nchw_conv(x, w, stride, padding):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


@pytest.mark.parametrize("size", [16, 15])
def test_conv1_is_the_stride_1_conv_subsampled(size):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, size, size, 3), generator=gen, dtype=torch.float64)
    w = torch.randn((7, 7, 3, 4), generator=gen, dtype=torch.float64)
    want = _nchw_conv(x, w, 2, 3)
    got = subsample(conv2d_ref(x, w))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # the stage's VJP: the gradient scattered back, then K2's and K3's
    # stride-1 plain versions
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    gx, gw = _grads(lambda a, b: _nchw_conv(a, b, 2, 3), x, w, g)
    gs = subsample_vjp(g, (2, size, size, 4))
    torch.testing.assert_close(conv2d_dx_ref(gs, w), gx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(conv2d_dw_ref(x, gs, 7, 7), gw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("size", [14, 7])
def test_a_1x1_stride_2_conv_is_a_subsample_then_a_stride_1_conv(size):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, size, size, 8), generator=gen, dtype=torch.float64)
    w = torch.randn((1, 1, 8, 16), generator=gen, dtype=torch.float64)
    want = _nchw_conv(x, w, 2, 0)
    torch.testing.assert_close(conv2d_ref(subsample(x), w), want, rtol=1e-12, atol=1e-12)
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    gx, gw = _grads(lambda a, b: _nchw_conv(a, b, 2, 0), x, w, g)
    torch.testing.assert_close(subsample_vjp(conv2d_dx_ref(g, w), x.shape), gx,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(conv2d_dw_ref(subsample(x), g, 1, 1), gw,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
def test_batch_norm_is_f_batch_norm_in_training(dtype, tol):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((4, 5, 6, 7), generator=gen) * 3 + 1).to(dtype).requires_grad_()
    gamma = torch.rand((7,), generator=gen).to(dtype).requires_grad_()
    beta = torch.randn((7,), generator=gen).to(dtype).requires_grad_()
    want = F.batch_norm(x.permute(0, 3, 1, 2), None, None, gamma, beta, training=True,
                        eps=1e-5).permute(0, 2, 3, 1)
    got = batch_norm(x, gamma, beta)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    g = torch.randn(want.shape, generator=gen).to(dtype)
    want_grads = torch.autograd.grad(want, (x, gamma, beta), g)
    for a, b in zip(torch.autograd.grad(got, (x, gamma, beta), g), want_grads):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    # the stages' backward half, from the forward half's statistics
    _, mean, rstd = batch_norm_fwd(x.detach(), gamma.detach(), beta.detach())
    for a, b in zip(batch_norm_bwd(x.detach(), mean, rstd, gamma.detach(), g), want_grads):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


def test_the_norms_and_the_shortcuts_are_spans():
    params = init_resnet(torch.Generator().manual_seed(0), SMALL)
    cluster = HeteroCluster([1.0], ["torch:cpu"], pipeline=True, microbatches=MICRO)
    batches = _batches(3)
    try:
        cluster.probe(image_size=SIZE, in_channels=3, kernel_size=7, num_kernels=8,
                      batch=BATCH)
        step = make_cluster_train_step(cluster, SMALL, lr=LR, device="cpu")
        params, _, _ = step(params, batches[0]["images"], batches[0]["labels"])
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)):
            for b in batches[1:]:
                params, _, _ = step(params, b["images"], b["labels"])
    finally:
        cluster.shutdown()
    c = spans.counters()
    assert c["step"].count == 2 and c["step.head"].count == 2 * MICRO
    # a BN forward and backward per conv and microbatch
    assert c["step.norm"].count == 2 * MICRO * 2 * 53
    assert c["step.norm"].s_by[("sweep", "fwd")] + c["step.norm"].s_by[("sweep", "bwd")] \
        == pytest.approx(c["step.norm"].s)
    # BN's input: conv1's subsampled output and every other conv's, both sweeps
    mb, h, per_image = BATCH // MICRO, SIZE // 2, 0
    per_image += h * h * 4
    h //= 2
    for l in resnet_layers(SMALL)[1:]:
        h = (h + 1) // 2 if l.stride == 2 and l.role != "a" else h
        per_image += h * h * l.cout
    assert c["step.norm"].bytes == 2 * 2 * MICRO * mb * 4 * per_image
    # a step: 16 adds, 15 gradient sums (every block's input but the
    # first's, the stem's, ... each a two-consumer tensor: 16), the
    # stem's subsample and its transpose, 3 strided subsamples and their
    # transposes: (16 + 16 + 2 + 6) a microbatch
    assert c["step.shortcut"].count == 2 * MICRO * (16 + 16 + 2 + 6)
    by_step = collections.Counter(s.step for s in spans.spans() if s.name == "step.norm")
    assert by_step == {0: MICRO * 2 * 53, 1: MICRO * 2 * 53}


def test_run_hetero_trains_resnet50_through_make_cluster_train_step():
    rec, history = hetero.run_hetero([1.0], ["torch:cpu"], device="cpu",
                                     train_pipeline=True, cfg=SMALL, batch=BATCH, steps=2,
                                     lr=LR, microbatches=MICRO)
    params, images, labels = hetero.train_inputs(SMALL, BATCH, "cpu")
    batch = {"images": images.numpy(), "labels": labels.numpy().astype(np.int32)}
    want, _, _ = ref.sgd_steps(_host(params), [batch], LR, REF_CFG, "cpu", BATCH // MICRO)
    assert rec["losses"][0] == pytest.approx(want[0], rel=LOSS_RTOL)
    _, after, _ = ref.sgd_steps(_host(params), [batch], LR, REF_CFG, "cpu", BATCH // MICRO)
    assert _gaps(_host(params), _host(history[0]), after)[0] < GRAD_RTOL
    assert rec["arch"] == SMALL.arch_id and len(rec["kernels_per_device"]) == 53
    assert sum(rec["kernels_per_device"]["res5c_branch2c"]) == 128
    assert len(history) == 2


@pytest.mark.parametrize("argv", [["--arch", "resnet50"], ["--serve", "--arch", "resnet50"]])
def test_the_cli_trains_resnet50_through_the_train_pipeline_only(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["hetero", "--device", "cpu"] + argv)
    with pytest.raises(SystemExit, match="--train-pipeline"):
        hetero.main()
