"""The residual network cell (``resnet50_train_gpu``, mode
``train_resnet``) on the CPU, cut as its driver cuts it off the card
(widths / 16, 64x64, batch 16 in 4 microbatches): the driver's
configuration and params against the program's, the timed path against
the plain reference, each fault it can have comes out not correct, a
program without residual configurations is refused at once; the readers
``norm_ms_per_step.train``, ``shortcut_ms_per_step.train`` and
``step_mfu_resnet.train`` on a synthetic run; ``work_resnet``'s count at
the published shapes by hand."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import run, spec, work, work_resnet
from portbench.drivers import train_resnet
from portbench.reference import resnet50 as ref
from conftest import CPU, ROOT, tiny_spec

CELL = "resnet50_train_gpu"
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: the cut's some 2,000 small ops a
    step gain nothing from more, and slow a hundredfold where the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       "resnet50_imagenet.json")))


def _correct(**cell):
    result, _ = run.run_cell(tiny_spec(CELL, **cell), SEED, 0.5, False, device="cpu",
                             backend_map=CPU)
    return result["correct"]


def test_the_driver_cuts_resnet50_off_the_card_and_matches_the_program_config():
    from repro_torch.configs.resnet50 import make_resnet50_config

    cut = train_resnet.off_card(_cfg())
    assert cut["stem_width"] == 4 and cut["image_size"] == 64
    assert [s["width"] for s in cut["stages"]] == [4, 8, 16, 32]
    for cfg, want in ((cut, make_resnet50_config(16, 64)), (_cfg(), make_resnet50_config())):
        got = train_resnet.program_config(cfg)
        assert (got.stages, got.image_size, got.stem_width, got.stem_kernel, got.expansion,
                got.num_classes, got.bn_eps) == (
            want.stages, want.image_size, want.stem_width, want.stem_kernel,
            want.expansion, want.num_classes, want.bn_eps)


def test_the_reference_and_the_program_name_and_count_the_same_params():
    from repro_torch.configs.resnet50 import CONFIG
    from repro_torch.models.resnet import init_resnet, resnet_param_count

    cfg = _cfg()
    names = ref.leaf_names(cfg)
    assert len(names) == 3 * 53 + 2
    program = init_resnet(torch.Generator(), CONFIG)
    drawn = train_resnet.init_params(cfg, SEED, "cpu")
    assert [(l, n) for l in program for n in program[l]] == names
    assert {(l, n): tuple(t.shape) for l, d in drawn.items() for n, t in d.items()} == {
        (l, n): tuple(t.shape) for l, d in program.items() for n, t in d.items()}
    assert sum(t.numel() for d in drawn.values() for t in d.values()) == cfg["parameters"]
    assert resnet_param_count(CONFIG) == cfg["parameters"] == 25_557_032
    assert [b[0] for b in ref.blocks(cfg) if b[2]] == ["2a", "3a", "4a", "5a"]


def test_the_driver_draws_he_normal_convs_unit_bn_and_a_0_01_head():
    p = train_resnet.init_params(train_resnet.off_card(_cfg()), SEED, "cpu")
    w = p["res4b_branch2b"]["kernel"]
    assert float(w.std()) == pytest.approx(np.sqrt(2.0 / (9 * 16)), rel=0.1)
    assert float(p["fc1000"]["kernel"].std()) == pytest.approx(0.01, rel=0.05)
    assert torch.equal(p["bn3a_branch1"]["gamma"], torch.ones(32))
    assert not p["bn3a_branch1"]["beta"].any() and not p["fc1000"]["bias"].any()


def test_work_resnet_counts_the_53_convs_and_the_fc_by_hand():
    # (output H, k, Cin, Cout) at the published strides
    convs = [(112, 7, 3, 64)]
    cin = 64
    for h, width, blocks in ((56, 64, 3), (28, 128, 4), (14, 256, 6), (7, 512, 3)):
        for j in range(blocks):
            if j == 0:
                convs.append((h, 1, cin, 4 * width))
            convs += [(h, 1, cin, width), (h, 3, width, width), (h, 1, width, 4 * width)]
            cin = 4 * width
    assert work_resnet.conv_layers(_cfg()) == convs
    fwd = [2 * h * h * k * k * i * o for h, k, i, o in convs]
    per_image = 3 * sum(fwd) - fwd[0] + 3 * 2 * 2048 * 1000
    assert sum(fwd) // 2 + 2048 * 1000 == _cfg()["forward_multiply_adds"] == 3_857_973_248
    assert work_resnet.image_flops(_cfg()) == per_image == 22_911_811_584
    assert work_resnet.train_step_flops(_cfg(), 128) == 2_932_711_882_752


def test_the_timed_path_follows_the_reference():
    s = tiny_spec(CELL)
    d = s.driver().Driver(s.cell, s.cfg, SEED, 0.5, "cpu", CPU)
    try:
        window = d.window(run.no_range)
    finally:
        d.close()
    assert window["images"] == window["steps"] * train_resnet.OFF_CARD_BATCH
    losses, p1, _ = ref.sgd_steps(d.params0, d.first, d.lr, d.cfg, "cpu", d.bn_group)
    assert d.bn_group == 4
    np.testing.assert_allclose(d.losses[0], losses[0], rtol=2e-6)
    assert d.check()["grad_norm_gap"] < 1e-3


def test_the_window_cycles_through_the_ring_after_the_checked_batches():
    s = tiny_spec(CELL)
    d = s.driver().Driver(s.cell, s.cfg, SEED, 1e9, "cpu", CPU)
    seen, step, ring = [], d.step, list(d.ring)

    def counted(params, images, labels):
        seen.append(images)
        if len(seen) == 6:
            d.seconds = -1.0  # the window closes after this step
        return step(params, images, labels)

    d.step = counted
    try:
        window = d.window(run.no_range)
    finally:
        d.close()
    assert len(d.first) == 3 and window["steps"] == 6
    assert [b["images"] for b in d.first] == [b["images"] for b in ring[:3]]
    order = [next(i for i, b in enumerate(ring) if b["images"] is x) for x in seen]
    assert train_resnet.OFF_CARD_RING == 4 and order == [3, 0, 1, 2, 3, 0]


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


def _one_leaf_off(monkeypatch, off):
    """Each step's update of one 1x1 conv's kernel replaced by
    ``off(update)``, as a kernel's error confined to one layer would."""
    leaf = "res4a_branch2a"

    def wrap(step):
        def wrong(params, images, labels):
            new, loss, acc = step(params, images, labels)
            w = params[leaf]["kernel"]
            new[leaf] = {"kernel": w - off(w - new[leaf]["kernel"])}
            return new, loss, acc
        return wrong

    _wrap_step(monkeypatch, wrap)
    s = tiny_spec(CELL)
    result, _ = run.run_cell(s, SEED, 0.5, False, device="cpu", backend_map=CPU)
    return {k: c["value"] / c["limit"] for k, c in result["checks"].items()}


def test_one_leaf_s_gradient_six_percent_long_is_not_correct(monkeypatch):
    # the whole gradient's norm moves too little to see it
    over = _one_leaf_off(monkeypatch, lambda u: 1.06 * u)
    assert over["grad_gap_leaf_max"] > 1.0
    assert over["grad_norm_gap"] < 1.0 and over["loss_gap_step1"] < 1.0


def test_one_leaf_s_gradient_turned_at_its_norm_is_not_correct(monkeypatch):
    # every norm stays as it was: only the difference shows it
    over = _one_leaf_off(monkeypatch, lambda u: u.roll(1, dims=-1))
    assert over["grad_err_leaf_max"] > 1.0
    assert over["grad_gap_leaf_max"] < 1.0 and over["grad_norm_gap"] < 1.0


def test_a_stage_that_drops_the_shortcut_s_gradient_is_not_correct(monkeypatch):
    from repro_torch.models import resnet

    real = resnet.stage_vjp

    def dropping(layer, sub_out, saved, g, bn):
        gy, dgamma, dbeta, g_sc = real(layer, sub_out, saved, g, bn)
        return gy, dgamma, dbeta, None if g_sc is None else torch.zeros_like(g_sc)

    monkeypatch.setattr(resnet, "stage_vjp", dropping)
    assert _correct() is False


def test_the_float32_witness_puts_the_reference_in_ieee_float32_in_the_program_s_place():
    s = tiny_spec(CELL)
    d = s.driver().Driver(s.cell, s.cfg, SEED, 0.0, "cpu", CPU)
    d.close()
    got = d.control("fp32")
    assert 0.0 < got["loss_gap_step1"] < 1e-6
    assert got["loss_gap_step1"] < d.control("tf32")["loss_gap_step1"]


def test_calibrate_resnet_s_witness_reads_each_seed_by_number_and_by_leaf(capsys, monkeypatch):
    from portbench import calibrate_resnet

    for var in run.CACHE_DIRS:
        monkeypatch.setenv(var, os.environ.get(var, ""))
    assert calibrate_resnet.main(["--witness", "--workload", CELL, "--seeds", "1",
                                  "--first-seed", str(SEED), "--device", "cpu"]) == 0
    seed, summary = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert seed["seed"] == SEED and set(summary["summary"]) == {"program", "fp32", "tf32"}
    for kind in ("program", "fp32", "tf32"):
        got = seed[kind]
        assert got["grad_gap_leaf_median"] <= got["grad_gap_leaf_max"]
        assert got["grad_gap_leaf_max_at"].rsplit(".", 1)[1] in ("kernel", "gamma", "beta",
                                                                   "bias")
        assert summary["summary"][kind]["grad_norm_gap"][0] == got["grad_norm_gap"]


def test_a_program_without_residual_configurations_is_refused_at_once(monkeypatch):
    import repro_torch.configs.base as base

    monkeypatch.delattr(base, "ResNetConfig")
    s = tiny_spec(CELL)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        s.driver().Driver(s.cell, s.cfg, SEED, 0.5, "cpu", CPU)
    assert time.perf_counter() - t0 < 5.0


def test_the_cell_lists_the_new_metrics_and_not_the_chain_s_laws():
    names = {m["name"] for m in spec.load(CELL).metrics(True)}
    assert {"norm_ms_per_step.train", "shortcut_ms_per_step.train", "step_mfu_resnet.train",
            "head_ms_per_step.train", "device_idle_share.train",
            "master_card_call_share.train"} <= names
    assert not names & {"train_mfu", "step_mfu.train", "cpu_kernel_fraction.train",
                        "plan_cpu_kernel_fraction.train", "cpu_shard_ms_per_step.train",
                        "backend_copy_ms_per_step.train"}


def test_the_new_readers_on_a_synthetic_run():
    from repro_torch.core import spans

    with profile(activities=[ProfilerActivity.CPU]):
        t = time.perf_counter()
        spans.record("step", t, t + 1.0)
        spans.record("step", t + 1.0, t + 2.0)
        spans.record("step.norm", t, t + 0.25, 4000, sweep="fwd")
        spans.record("step.norm", t + 1.0, t + 1.125, 4000, sweep="bwd")
        spans.record("step.shortcut", t, t + 0.5, 100)
    r = run.Run(CELL, spec.load(CELL).cell, _cfg(), 1.0,
                {"steps": 2, "images": 256, "seconds": 4.0})
    read = {m: spec.reader(m).read(r) for m in
            ("norm_ms_per_step.train", "shortcut_ms_per_step.train", "step_mfu_resnet.train")}
    assert read["norm_ms_per_step.train"] == pytest.approx(1e3 * 0.375 / 2)
    assert read["shortcut_ms_per_step.train"] == pytest.approx(1e3 * 0.5 / 2)
    assert read["step_mfu_resnet.train"] == pytest.approx(
        100 * 2 * 2_932_711_882_752 / (4.0 * work.PEAK_FP32_FLOPS))
    # silent on a configuration without bottleneck stages
    cifar = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                        "cifar_cnn_500_1500.json")))
    r = run.Run(CELL, {}, cifar, 1.0, {"steps": 2, "images": 64, "seconds": 4.0})
    assert spec.reader("step_mfu_resnet.train").read(r) is None

