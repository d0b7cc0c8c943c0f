"""The chain CNN cell (``vgg16_train_gpu``, mode ``train_chain``) on the
CPU, cut as its driver cuts it off the card (widths / 16, 32x32): the
timed path against the plain reference, each fault it can have comes
out not correct, a program without chain configurations is refused at
once; the readers ``step_mfu.train``, ``head_ms_per_step.train`` and
``activation_mb_per_step.train`` on a synthetic run; ``work_chain``'s
count against a hand sum and against ``work.py``'s CIFAR law; the
ImageNet-shaped traffic."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import run, spec, traffic_imagenet, work, work_chain
from portbench.drivers import train_chain
from portbench.reference import vgg16 as ref
from conftest import CPU, ROOT, tiny_spec

CELL = "vgg16_train_gpu"
SEED = 2 ** 31 + 12345


def _cfg():
    return json.load(open(os.path.join(ROOT, "portbench", "configs", "vgg16_imagenet.json")))


def _correct(**cell):
    result, _ = run.run_cell(tiny_spec(CELL, **cell), SEED, 0.5, False, device="cpu",
                             backend_map=CPU)
    return result["correct"]


def test_the_driver_cuts_vgg16_off_the_card_and_matches_the_program_config():
    from repro_torch.configs.vgg16 import make_vgg16_config

    cut = train_chain.off_card(_cfg())
    assert cut["blocks"] == [[4, 4], [8, 8], [16, 16, 16], [32, 32, 32], [32, 32, 32]]
    assert cut["dense"] == [256, 256, 1000] and cut["image_size"] == 32
    got = train_chain.program_config(cut)
    want = make_vgg16_config(16, 32)
    assert (got.convs, got.dense, got.image_size) == (want.convs, want.dense, want.image_size)
    assert train_chain.program_config(_cfg()).convs == make_vgg16_config().convs


def test_the_timed_path_follows_the_reference_step_by_step():
    s = tiny_spec(CELL)
    d = s.driver().Driver(s.cell, s.cfg, SEED, 0.5, "cpu", CPU)
    try:
        d.window(run.no_range)
    finally:
        d.close()
    losses, p1, _ = ref.sgd_steps(d.params0, d.first, d.lr, d.cfg, "cpu", SEED)
    np.testing.assert_allclose(d.losses, losses, rtol=2e-6)
    for layer in p1:
        for name in p1[layer]:
            np.testing.assert_allclose(d.params1[layer][name], p1[layer][name],
                                       rtol=1e-4, atol=1e-6)


def _wrap_step(monkeypatch, wrap):
    import repro_torch.models.cnn as cnn

    orig = cnn.make_cluster_train_step
    monkeypatch.setattr(cnn, "make_cluster_train_step",
                        lambda *a, **k: wrap(orig(*a, **k)))


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    def wrap(step):
        def unchanged(params, images, labels):
            _, loss, acc = step(params, images, labels)
            return params, loss, acc
        return unchanged

    _wrap_step(monkeypatch, wrap)
    assert _correct() is False


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    def wrap(step):
        def half(params, images, labels):
            n = len(images) // 2
            return step(params, images[:n], labels[:n])
        return half

    _wrap_step(monkeypatch, wrap)
    assert _correct() is False


def test_other_dropout_masks_are_not_correct(monkeypatch):
    import repro_torch.models.cnn as cnn

    orig = cnn.dropout_masks
    monkeypatch.setattr(cnn, "dropout_masks",
                        lambda cfg, seed, step, batch: orig(cfg, seed + 1, step, batch))
    assert _correct() is False


def test_a_program_without_chain_configurations_is_refused_at_once(monkeypatch):
    import repro_torch.configs.base as base

    monkeypatch.delattr(base, "ConvChainConfig")
    s = tiny_spec(CELL)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        s.driver().Driver(s.cell, s.cfg, SEED, 0.5, "cpu", CPU)
    assert time.perf_counter() - t0 < 5.0


def test_the_cell_lists_the_shape_generic_metrics_and_not_the_cifar_law():
    names = {m["name"] for m in spec.load(CELL).metrics(True)}
    assert {"step_mfu.train", "head_ms_per_step.train", "activation_mb_per_step.train",
            "conv_fwd_roofline.train", "conv_bwd_roofline.train",
            "copy_ms_per_step.train", "device_idle_share.train",
            "backend_weight_mb_per_step.train", "gather_wait_ms_per_step.train"} <= names
    assert not names & {"train_mfu", "cpu_kernel_fraction.train",
                        "plan_cpu_kernel_fraction.train", "cpu_shard_ms_per_step.train"}


def _synthetic_run(cfg, cell):
    """A Run whose window took 2 steps in 4 s, with the program's spans
    recorded by hand under a profiler."""
    from repro_torch.core import spans

    with profile(activities=[ProfilerActivity.CPU]):
        t = time.perf_counter()
        spans.record("step", t, t + 1.0)
        spans.record("step", t + 1.0, t + 2.0)
        spans.record("step.head", t, t + 0.25, 4000)
        spans.record("step.head", t + 1.0, t + 1.125, 4000)
        spans.record("step.to_card", t, t + 0.1, 1_000_000)
        spans.record("step.to_host", t, t + 0.1, 3_000_000)
        spans.record("cuda.to_card", t, t + 0.1, {"x": 5_000_000, "w": 7_000_000,
                                                   "g": 11_000_000})
        spans.record("cuda.to_host", t, t + 0.1, {"y": 13_000_000})
        spans.record("cuda.to_host", t, t + 0.1, {"dx": 17_000_000, "dw": 19_000_000})
    return run.Run(CELL, cell, cfg, 1.0, {"steps": 2, "images": 64, "seconds": 4.0})


def test_the_new_readers_on_a_synthetic_run():
    cfg, cell = _cfg(), spec.load(CELL).cell
    r = _synthetic_run(cfg, cell)
    read = {m: spec.reader(m).read(r) for m in
            ("step_mfu.train", "head_ms_per_step.train", "activation_mb_per_step.train")}
    assert read["head_ms_per_step.train"] == pytest.approx(1e3 * 0.375 / 2)
    # the stages' 4 MB and the backend's x, g, y, dx (not w, dw) over 2 steps
    assert read["activation_mb_per_step.train"] == pytest.approx((4 + 5 + 11 + 13 + 17) / 2)
    assert read["step_mfu.train"] == pytest.approx(
        100 * 2 * work_chain.train_step_flops(cfg, 32) / (4.0 * work.PEAK_FP32_FLOPS))
    # the CIFAR cells read what train_mfu reads
    cifar = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                        "cifar_cnn_500_1500.json")))
    r = _synthetic_run(cifar, cell)
    assert spec.reader("step_mfu.train").read(r) == pytest.approx(
        spec.reader("train_mfu").read(r), rel=1e-12)


def test_work_chain_counts_the_13_convs_and_3_fcs_by_hand():
    # (H, Cin, Cout) of conv1_1 .. conv5_3, 3x3 each
    convs = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
             (56, 128, 256), (56, 256, 256), (56, 256, 256), (28, 256, 512),
             (28, 512, 512), (28, 512, 512), (14, 512, 512), (14, 512, 512),
             (14, 512, 512)]
    fwd = [2 * h * h * 9 * cin * cout for h, cin, cout in convs]
    fcs = [2 * 25088 * 4096, 2 * 4096 * 4096, 2 * 4096 * 1000]
    per_image = 3 * sum(fwd) - fwd[0] + 3 * sum(fcs)
    assert work_chain.conv_layers(_cfg()) == [(h, i, o, 3) for h, i, o in convs]
    assert work_chain.train_step_flops(_cfg(), 32) == 32 * per_image == 2_964_741_685_248


@pytest.mark.parametrize("name", ["cifar_cnn_500_1500", "cifar_cnn_150_800"])
def test_work_chain_counts_the_cifar_net_as_work_py_does(name):
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", name + ".json")))
    assert work_chain.train_step_flops(cfg, 32) == work.train_step_flops(cfg, 32)


def test_imagenet_batches_are_the_seed_s_and_carry_their_class():
    a = traffic_imagenet.synthetic_imagenet_batches(16, seed=SEED)
    b = traffic_imagenet.synthetic_imagenet_batches(16, seed=SEED)
    x, y = next(a), next(b)
    assert x["images"].shape == (16, 224, 224, 3) and x["images"].dtype == np.float32
    assert x["labels"].dtype == np.int32 and 0 <= x["labels"].min() <= x["labels"].max() < 1000
    assert np.array_equal(x["images"], y["images"]) and np.array_equal(x["labels"], y["labels"])
    assert not np.array_equal(next(a)["images"], x["images"])
    # each 32x32 patch holds one template value a channel: the patch mean
    # stays within the noise's 0.5 / 32 of it, so two images of one class
    # agree patch by patch
    c = next(traffic_imagenet.synthetic_imagenet_batches(2, seed=SEED, num_classes=1))
    means = c["images"].reshape(2, 7, 32, 7, 32, 3).mean(axis=(2, 4))
    assert np.abs(means[0] - means[1]).max() < 0.1
    assert float(np.std(c["images"] - c["images"].reshape(2, 7, 32, 7, 32, 3).mean(
        axis=(2, 4)).repeat(32, 1).repeat(32, 2))) == pytest.approx(0.5, rel=0.02)


def test_torch_generator_masks_match_the_program_s():
    from repro_torch.configs.vgg16 import make_vgg16_config
    from repro_torch.models.cnn import dropout_masks

    cut = train_chain.off_card(_cfg())
    want = dropout_masks(make_vgg16_config(16, 32), SEED, 2, 8)
    got = ref.masks(cut, SEED, 2, 8, torch.float32, "cpu")
    assert got[2] is None and all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
