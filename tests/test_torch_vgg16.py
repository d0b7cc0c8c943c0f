"""VGG-16 (configuration D of arXiv:1409.1556) through the port's one
training step, ``make_cluster_train_step``, held on the CPU against the
plain float64 reference (``tests/_vgg16_reference.py``) at a small size:
the VGG topology with every width divided by 16 on 32x32 inputs.  The
step on ``torch:cpu`` and ``numpy,torch:cpu`` clusters: the loss, each
leaf's gradient and the change after 2 steps; the dropout masks the same
for 1, 2 and 4 microbatches; the spans ``step.head`` and ``step.masks``;
the launcher's ``--arch``.  The paper's CIFAR CNN through the same
step keeps the numbers it had before the step took any chain."""
import collections
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(__file__))

import _vgg16_reference as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.vgg16 import make_vgg16_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.cluster.cluster import HeteroCluster  # noqa: E402
from repro_torch.launch import hetero  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    DENSE_INIT_STD,
    conv_chain,
    dropout_masks,
    init_chain,
    init_cnn,
    make_cluster_train_step,
    make_cnn_config,
)

DIV, SIZE, BATCH, LR = 16, 32, 4, 0.01
SMALL = make_vgg16_config(DIV, SIZE)
# the reference's own description of the same network
REF_CFG = {"blocks": [[64 // DIV] * 2, [128 // DIV] * 2, [256 // DIV] * 3,
                      [512 // DIV] * 3, [512 // DIV] * 3],
           "dense": [4096 // DIV, 4096 // DIV, 1000], "dropout": [0.5, 0.5, 0.0]}


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal((BATCH, SIZE, SIZE, 3), dtype=np.float32),
             "labels": rng.integers(0, 1000, BATCH).astype(np.int32)} for _ in range(n)]


def _host(params):
    return {l: {n: t.detach().cpu().numpy().astype(np.float64) for n, t in d.items()}
            for l, d in params.items()}


def _train(backends, batches, microbatches=2, dropout_seed=11, cfg=SMALL):
    """``make_cluster_train_step``'s steps from ``init_chain``'s seed-0
    params: (params0, losses, params after step 1, params after the
    last), numpy."""
    params = init_chain(torch.Generator().manual_seed(0), cfg)
    p0 = _host(params)
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True,
                            microbatches=microbatches)
    try:
        cluster.probe(image_size=SIZE, in_channels=3, kernel_size=3, num_kernels=8,
                      batch=BATCH)
        step = make_cluster_train_step(cluster, cfg, lr=LR, device="cpu",
                                       dropout_seed=dropout_seed)
        losses, after = [], []
        for b in batches:
            params, loss, _ = step(params, b["images"], b["labels"])
            losses.append(loss)
            after.append(_host(params))
    finally:
        cluster.shutdown()
    return p0, losses, after[0], after[-1]


def _close(got, want, p0, scale, rtol=1e-3):
    """``got`` within ``rtol`` of ``want`` (by norm), give or take what
    float32 params can hold: a step's update of ``p0`` is rounded to
    half an ulp of each entry, and ``scale`` carries that rounding into
    ``got``'s units (1 / lr for a gradient read from the params, the
    number of steps for a change)."""
    err = np.linalg.norm(got - want)
    return err <= rtol * np.linalg.norm(want) + scale * 2.0 ** -24 * np.linalg.norm(p0)


def test_vgg16_is_table_1_configuration_d():
    cfg = get_config("vgg16")
    assert cfg == make_vgg16_config() and cfg.arch_id == "vgg16"
    assert [c.kernels for c in cfg.convs] == [64, 64, 128, 128, 256, 256, 256,
                                             512, 512, 512, 512, 512, 512]
    assert {c.kernel_size for c in cfg.convs} == {3} and not any(c.lrn for c in cfg.convs)
    assert [c.name for c in cfg.convs if c.pool] == ["conv1_2", "conv2_2", "conv3_3",
                                                     "conv4_3", "conv5_3"]
    assert [(d.name, d.units, d.relu, d.dropout) for d in cfg.dense] == [
        ("fc6", 4096, True, 0.5), ("fc7", 4096, True, 0.5), ("fc8", 1000, False, 0.0)]
    assert (cfg.image_size, cfg.image_channels, cfg.num_classes, cfg.dtype) == (
        224, 3, 1000, "float32")
    # 138,357,544 parameters, reckoned from the shapes init_chain draws
    cin, h, n = 3, 224, 0
    for c in cfg.convs:
        n += 9 * cin * c.kernels + c.kernels
        cin, h = c.kernels, h // 2 if c.pool else h
    assert h * h * cin == 25088
    n_in = h * h * cin
    for d in cfg.dense:
        n += n_in * d.units + d.units
        n_in = d.units
    assert n == 138_357_544


def test_init_chain_draws_he_normal_convs_a_0_01_head_and_zero_biases():
    params = init_chain(torch.Generator().manual_seed(0), SMALL)
    assert list(params) == [c.name for c in SMALL.convs] + ["fc6", "fc7", "fc8"]
    assert params["conv1_1"]["kernel"].shape == (3, 3, 3, 4)
    assert params["fc6"]["kernel"].shape == (32, 256)
    for name, std in (("conv5_3", math.sqrt(2.0 / (9 * 32))),
                      ("fc7", DENSE_INIT_STD), ("fc8", DENSE_INIT_STD)):
        assert float(params[name]["kernel"].std()) == pytest.approx(std, rel=0.05)
        assert not params[name]["bias"].any()
    assert DENSE_INIT_STD == 0.01


@pytest.mark.parametrize("backends", [["torch:cpu"], ["numpy", "torch:cpu"]])
def test_the_step_matches_the_reference(backends):
    batches = _batches(2)
    p0, losses, p1, p2 = _train(backends, batches)
    want_losses, want1, want2 = ref.sgd_steps(p0, batches, LR, REF_CFG, "cpu", 11)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-6)
    for layer in p0:
        for name in p0[layer]:
            w = p0[layer][name]
            g, g_ref = (w - p1[layer][name]) / LR, (w - want1[layer][name]) / LR
            assert _close(g, g_ref, w, 1 / LR), (layer, name)
            assert _close(p2[layer][name] - w, want2[layer][name] - w, w, 2), (layer, name)


def test_the_tf32_control_is_further_from_the_reference_than_the_step():
    # by the first gradient: the head's 0.01 init leaves the small
    # network's logits near 0, so its loss is ln(1000) to float32's ulp
    # in either precision
    batches = _batches(1)
    p0, _, p1, _ = _train(["torch:cpu"], batches)
    _, want, _ = ref.sgd_steps(p0, batches, LR, REF_CFG, "cpu", 11)
    _, tf32, _ = ref.sgd_steps(p0, batches, LR, REF_CFG, "cpu", 11, tf32=True)

    def gap(p):
        return math.sqrt(sum(float(np.sum((p[l][n] - want[l][n]) ** 2))
                             for l in p0 for n in p0[l]))

    assert 3 * gap(p1) < gap(tf32)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_the_masks_do_not_depend_on_the_microbatch_split(microbatches):
    batches = _batches(2, seed=5)
    p0, losses, _, p2 = _train(["torch:cpu"], batches, microbatches=microbatches)
    want_losses, _, want2 = ref.sgd_steps(p0, batches, LR, REF_CFG, "cpu", 11)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-6)
    for layer in p0:
        for name in p0[layer]:
            w = p0[layer][name]
            assert _close(p2[layer][name] - w, want2[layer][name] - w, w, 2), (layer, name)


def test_dropout_masks_by_seed_and_step():
    a = dropout_masks(SMALL, 7, 0, 64)
    assert a[2] is None and [m.shape for m in a[:2]] == [(64, 256), (64, 256)]
    for m in a[:2]:
        assert set(torch.unique(m).tolist()) == {0.0, 2.0}
        assert 0.4 < float((m > 0).float().mean()) < 0.6
    assert torch.equal(a[0], dropout_masks(SMALL, 7, 0, 64)[0])
    assert not torch.equal(a[0], dropout_masks(SMALL, 7, 1, 64)[0])
    assert not torch.equal(a[0], dropout_masks(SMALL, 8, 0, 64)[0])
    # a seed past 2**31, as the benchmark's are
    want = ref.masks(REF_CFG, 2 ** 31 + 99, 3, 8, torch.float32, "cpu")
    got = dropout_masks(SMALL, 2 ** 31 + 99, 3, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_cifar_cnn_keeps_its_numbers():
    # two steps of the paper's net at C1 4, C2 8 on one torch:cpu device,
    # as make_cluster_train_step gave them while it knew only this network
    cfg = make_cnn_config(4, 8)
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    p0 = _host(params)
    images = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1)).numpy()
    cluster = HeteroCluster([1.0], ["torch:cpu"], pipeline=True, microbatches=2)
    try:
        cluster.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=8, batch=4)
        step = make_cluster_train_step(cluster, cfg, lr=0.05, device="cpu")
        losses = []
        for _ in range(2):
            params, loss, _ = step(params, images, np.arange(4) % 10)
            losses.append(loss)
    finally:
        cluster.shutdown()
    np.testing.assert_allclose(losses, [2.6320035457611084, 1.679686427116394], rtol=1e-6)
    change = {"conv1": (0.10151201887410137, 0.0056086710725141665),
              "conv2": (0.08497819855783505, 0.008842423806310768),
              "fc": (0.35797428575969437, 0.03429509530094349)}
    got = _host(params)
    for layer, (dk, db) in change.items():
        for name, want in (("kernel", dk), ("bias", db)):
            assert np.linalg.norm(got[layer][name] - p0[layer][name]) == pytest.approx(
                want, rel=1e-5), (layer, name)


def test_the_cifar_cnn_is_a_chain_of_two_convs_and_one_fc():
    chain = conv_chain(make_cnn_config(4, 8))
    assert [(c.name, c.kernels, c.kernel_size, c.lrn, c.pool) for c in chain.convs] == [
        ("conv1", 4, 5, True, True), ("conv2", 8, 5, True, True)]
    assert [(d.name, d.units, d.relu, d.dropout) for d in chain.dense] == [
        ("fc", 10, False, 0.0)]
    assert conv_chain(SMALL) is SMALL


def test_the_head_and_the_masks_are_spans():
    params = init_chain(torch.Generator().manual_seed(0), SMALL)
    cluster = HeteroCluster([1.0], ["torch:cpu"], pipeline=True, microbatches=2)
    batches = _batches(3)
    try:
        cluster.probe(image_size=SIZE, in_channels=3, kernel_size=3, num_kernels=8,
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
    assert c["step"].count == 2 and c["step.head"].count == 4 and c["step.masks"].count == 2
    # z: 2 rows of 1x1x32 floats; the masks: 4 rows of fc6's and fc7's 256
    assert c["step.head"].bytes == 4 * 2 * 32 * 4
    assert c["step.masks"].bytes == 2 * 4 * BATCH * 2 * 256
    assert c["step.head"].s_by[("rows", 2)] == pytest.approx(c["step.head"].s)
    assert c["step.head"].s_by[("layers", 3)] == pytest.approx(c["step.head"].s)
    by_step = collections.Counter(s.step for s in spans.spans() if s.name == "step.head")
    assert by_step == {0: 2, 1: 2}


def test_run_hetero_trains_vgg16_through_make_cluster_train_step():
    rec, history = hetero.run_hetero([1.0], ["torch:cpu"], device="cpu",
                                     train_pipeline=True, cfg=SMALL, batch=BATCH, steps=2,
                                     lr=LR, microbatches=2)
    params, images, labels = hetero.train_inputs(SMALL, BATCH, "cpu")
    batch = {"images": images.numpy(), "labels": labels.numpy()}
    want, _, _ = ref.sgd_steps(_host(params), [batch, batch], LR, REF_CFG, "cpu", 0)
    np.testing.assert_allclose(rec["losses"], want, rtol=2e-6)
    assert rec["arch"] == SMALL.arch_id and sum(rec["kernels_per_device"]["conv5_3"]) == 32
    assert len(history) == 2


@pytest.mark.parametrize("argv", [["--arch", "vgg16"], ["--serve", "--arch", "vgg16"]])
def test_the_cli_trains_an_arch_through_the_train_pipeline_only(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["hetero", "--device", "cpu"] + argv)
    with pytest.raises(SystemExit, match="--train-pipeline"):
        hetero.main()
