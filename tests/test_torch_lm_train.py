"""The port's LM training step (``train/step.py``), its remat policies
and its launcher (``launch/train.py``), against the JAX package.

``make_train_step`` is held against the JAX ``make_train_step`` (remat
``none``, no mesh) on reduced yi-6b (dense), mamba2-370m (ssm) and
hymba-1.5b (hybrid) with sgd, adam and adafactor, step by step
(tests/_torch_train_parity.py states how and at which tolerances; the
MoE, VLM and encoder-decoder families and the launcher are in
tests/test_torch_lm_train_zoo.py); tests/test_train.py's cases are
mirrored on the port.  On CPU tensors the forward runs the kernels'
plain versions and the backward ``flash_attention_vjp`` / ``ssd_vjp``,
as the card runs K4 and K5 and the same vjps (chip_smoke.py's
``lm_train``).
"""
import numpy as np
import pytest
import torch
from _torch_train_parity import check_step_parity

from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import synthetic_token_batches
from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref
from repro_torch.models.registry import build_model
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adafactor"])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m", "hymba-1.5b"])
def test_train_step_matches_jax(arch, opt):
    check_step_parity(arch, opt)


def test_grad_accum_matches_jax():
    """Two microbatches accumulated in float32 and scaled by 1/2, against
    the JAX step's ``lax.scan`` over the same microbatches."""
    check_step_parity("hymba-1.5b", "sgd", batch=4, grad_accum=2)


def _cfg():
    """tests/test_train.py's small dense config."""
    return ModelConfig(arch_id="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32",
                       param_dtype="float32")


def _batches(cfg, b, s):
    it = synthetic_token_batches(b, s, cfg.vocab_size)
    return ({k: torch.from_numpy(v) for k, v in next(it).items()} for _ in iter(int, 1))


@pytest.mark.parametrize("opt,lr", [("sgd", 0.1), ("adam", 1e-3), ("adafactor", 1e-2)])
def test_loss_decreases(opt, lr):
    cfg = _cfg()
    api = build_model(cfg)
    run = RunConfig(optimizer=opt, learning_rate=lr, warmup_steps=5, total_steps=60,
                    remat="none")
    state = init_train_state(torch.Generator().manual_seed(0), api, run, "cpu")
    step = make_train_step(api, run)
    batches = _batches(cfg, 8, 16)
    losses = []
    for _ in range(60):
        state, m = step(state, next(batches))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5


def test_grad_accum_equivalent_to_full_batch():
    cfg = _cfg()
    api = build_model(cfg)
    base = dict(optimizer="sgd", learning_rate=0.1, max_grad_norm=None,
                schedule="constant", warmup_steps=0)
    run1, run4 = RunConfig(grad_accum=1, **base), RunConfig(grad_accum=4, **base)
    s1 = init_train_state(torch.Generator().manual_seed(0), api, run1, "cpu")
    s4 = init_train_state(torch.Generator().manual_seed(0), api, run4, "cpu")
    batch = next(_batches(cfg, 8, 16))
    s1, m1 = make_train_step(api, run1)(s1, batch)
    s4, m4 = make_train_step(api, run4)(s4, batch)
    assert np.isclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_grad_clipping_bounds_norm():
    cfg = _cfg()
    api = build_model(cfg)
    run = RunConfig(optimizer="sgd", learning_rate=1.0, max_grad_norm=1e-8)
    state = init_train_state(torch.Generator().manual_seed(0), api, run, "cpu")
    new_state, m = make_train_step(api, run)(state, next(_batches(cfg, 4, 8)))
    assert float(m["grad_norm"]) > 1e-8
    # with a tiny clip threshold the params barely move
    assert max((a - b).abs().max().item() for a, b in
               zip(tree_leaves(state.params), tree_leaves(new_state.params))) < 1e-6


def test_step_leaves_the_old_state_as_it_was():
    cfg = _cfg()
    api = build_model(cfg)
    run = RunConfig(optimizer="adam", learning_rate=1e-2)
    state = init_train_state(torch.Generator().manual_seed(0), api, run, "cpu")
    before = [p.clone() for p in tree_leaves(state.params)]
    new, _ = make_train_step(api, run)(state, next(_batches(cfg, 4, 8)))
    assert new.step == 1 and state.step == 0 and new.opt_state["count"] == 1
    assert all(torch.equal(a, b) and not b.requires_grad
               for a, b in zip(before, tree_leaves(state.params)))
    assert not any(p.requires_grad for p in tree_leaves(new.params))


def _grads(arch, remat, fns=None):
    cfg = reduced_for_smoke(get_config(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))}
    if cfg.vision is not None:
        v = cfg.vision
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((2, v.num_image_tokens, v.vision_dim)).astype(np.float32))
    if cfg.audio is not None:
        a = cfg.audio
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, a.num_frames, a.frame_dim)).astype(np.float32))
    logits, aux = api.forward(params, batch, remat=remat, **(fns or {}))
    loss = logits.float().square().mean() + aux
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "moonshot-v1-16b-a3b", "whisper-medium"])
def test_remat_gives_equal_gradients(arch, remat):
    """Remat changes what is kept, not a number: the gradients under
    ``full`` and ``dots`` equal those under ``none`` (atol 1e-6: the same
    ops on the same values, recomputed)."""
    want = _grads(arch, "none")
    got = _grads(arch, remat)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_remat_full_reruns_each_blocks_attention_and_scan():
    """Under ``full`` each block's attention and SSD scan run twice per
    step (forward, and the backward's recompute), as chip_smoke.py's
    ``lm_train`` counts K4's and K5's launches; under ``none`` once."""
    calls = {"attn": 0, "ssd": 0}

    def attn(*a, **kw):
        calls["attn"] += 1
        return flash_attention_ref(*a, **kw)

    def scan(*a, chunk):
        calls["ssd"] += 1
        return ssd_chunked_ref(*a, min(chunk, a[0].shape[1]))

    for remat, per_layer in (("none", 1), ("full", 2)):
        calls.update(attn=0, ssd=0)
        _grads("hymba-1.5b", remat, {"attention_fn": attn, "ssd_fn": scan})
        assert calls == {"attn": 2 * per_layer, "ssd": 2 * per_layer}, (remat, calls)
