"""The rest of the model zoo's serving path in the port — MoE blocks, the
VLM projector, caller-supplied positions and the encoder-decoder family
— against the JAX package.

One JAX parameter tree (``init_lm`` or ``init_encdec``) is carried
across with ``repro_torch.convert``; the same numpy tokens, patch
embeddings and frame embeddings go through both packages' ``forward``,
``prefill`` (logits and every cache entry) and ``decode_step``, for
reduced mixtral-8x22b, qwen3-moe-235b-a22b, moonshot-v1-16b-a3b,
llava-next-mistral-7b and whisper-medium and small VLM configs.  The
MoE layer is held against ``apply_moe`` (``mesh=None``) with and
without capacity drops; its dispatch tables are held equal to the JAX
package's exactly.  The port runs the kernels' plain versions here (CPU
tensors); the card runs K4 in chip_smoke.py's ``lm_zoo`` phase and
tests/test_torch_gpu.py.  Tolerance: tests/test_serve.py's atol = rtol =
2e-3 (fp32; the two packages sum in different orders).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import VisionStubConfig as JaxVisionStubConfig
from repro.layers import attention as jax_attn
from repro.layers import moe as jax_moe
from repro.models import encdec as jax_encdec
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import rules_for_mode
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ModelConfig, MoEConfig, VisionStubConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch.serve import make_batch
from repro_torch.layers import moe
from repro_torch.models import encdec
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
RULES = rules_for_mode("megatron")
ATOL = RTOL = 2e-3
N_PROMPT, N_TOTAL = 10, 24
MOE_ARCHS = ("mixtral-8x22b", "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    """tests/test_serve.py's small config, in both packages."""
    base = dict(arch_id="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=97, dtype="float32",
                param_dtype="float32")
    moe_kw, vision_kw = kw.pop("moe", None), kw.pop("vision", None)
    base.update(kw)
    jcfg = JaxModelConfig(**base, moe=moe_kw and JaxMoEConfig(**moe_kw),
                          vision=vision_kw and JaxVisionStubConfig(**vision_kw))
    tcfg = ModelConfig(**base, moe=moe_kw and MoEConfig(**moe_kw),
                       vision=vision_kw and VisionStubConfig(**vision_kw))
    return jcfg, tcfg


def _reduced(arch):
    return jax_reduced(jax_get_config(arch)), reduced_for_smoke(get_config(arch))


VLM = dict(vision_dim=16, num_image_tokens=4, projector_hidden=32)
CASES = {f"{arch} reduced": _reduced(arch) for arch in MOE_ARCHS + ("llava-next-mistral-7b",)}
CASES.update({
    "moe top-2 of 4": _pair(family="moe", moe=dict(num_experts=4, experts_per_token=2,
                                                   expert_d_ff=48)),
    "moe with drops": _pair(family="moe", moe=dict(num_experts=4, experts_per_token=2,
                                                   expert_d_ff=48, capacity_factor=0.5)),
    "vlm": _pair(family="vlm", vision=VLM),
    # a window of 8 slots: decode passes the ring's wrap
    "vlm swa": _pair(family="vlm", vision=VLM, sliding_window=8),
})


def _models(name):
    jcfg, tcfg = CASES[name]
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0)))
    return jcfg, japi, jparams, tapi, convert.lm_params_from_numpy(jparams, tcfg, "cpu")


def _batch(cfg, b, s, seed=1):
    """Numpy tokens, and patches or frames where the config takes them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s))}
    if cfg.vision is not None:
        v = cfg.vision
        batch["patches"] = rng.standard_normal(
            (b, v.num_image_tokens, v.vision_dim)).astype(np.float32)
    if cfg.audio is not None:
        a = cfg.audio
        batch["frames"] = rng.standard_normal((b, a.num_frames, a.frame_dim)).astype(
            np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, msg):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=ATOL, rtol=RTOL,
                               err_msg=msg)


def _check_cache(tcache, jcache, msg):
    assert sorted(tcache) == sorted(jcache)
    assert tcache["t"] == int(jcache["t"])
    for key in sorted(set(jcache) - {"t"}):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key], f"{msg} cache[{key!r}]")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_and_runs_reduced(arch):
    """All ten configurations build at full size (no family refused), and
    each runs a reduced forward whose logits are finite."""
    api = build_model(get_config(arch))
    assert api.cfg.arch_id == arch
    cfg = reduced_for_smoke(get_config(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    logits, aux = api.forward(params, make_batch(cfg, seed=0, batch=1, prompt_len=12,
                                                  device="cpu"))
    assert tuple(logits.shape) == (1, 12, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


# ---------------------------------------------------------------------------
# the MoE layer


def _moe_cfgs(capacity_factor, e=4, k=2):
    kw = dict(arch_id="t", family="moe", num_layers=1, d_model=16, num_heads=2,
              num_kv_heads=2, d_ff=24, vocab_size=16, dtype="float32",
              param_dtype="float32")
    mk = dict(num_experts=e, experts_per_token=k, expert_d_ff=24,
              capacity_factor=capacity_factor)
    return (JaxModelConfig(**kw, moe=JaxMoEConfig(**mk)),
            ModelConfig(**kw, moe=MoEConfig(**mk)))


def _routing_jax(jp, x, moe_cfg):
    """The JAX package's router, top-k and renormalised gates (as
    ``_moe_local`` computes them)."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["kernel"], axis=-1)
    gate, idx = jax.lax.top_k(probs, moe_cfg.experts_per_token)
    return gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9), idx


# (capacity factor, experts, k): no drops, and drops forced at 0.5
MOE_LAYER_CASES = [(100.0, 4, 2), (0.5, 4, 2), (1.25, 8, 3), (0.5, 8, 3)]


@pytest.mark.parametrize("cf,e,k", MOE_LAYER_CASES)
def test_apply_moe_matches_jax(cf, e, k):
    jcfg, tcfg = _moe_cfgs(cf, e, k)
    jp = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(0), 16, jcfg.moe,
                                                   jnp.float32))
    x = np.random.default_rng(1).standard_normal((2, 24, 16)).astype(np.float32)
    want, want_aux = jax_moe.apply_moe(jp, jnp.asarray(x), cfg=jcfg)
    got, aux = moe.apply_moe(convert.params_from_numpy(jp, "cpu"), torch.from_numpy(x),
                             cfg=tcfg)
    _close(got, want, "moe out")
    _close(aux, want_aux, "moe aux")
    t = x.shape[0] * x.shape[1]
    assert moe._capacity(t, tcfg.moe) == jax_moe._capacity(t, jcfg.moe)
    dropped = (np.abs(np.asarray(want)).reshape(t, -1).sum(-1) == 0).sum()
    assert (dropped > 0) == (cf < 1.0)  # drops exactly where forced


@pytest.mark.parametrize("cf,e,k", MOE_LAYER_CASES)
def test_dispatch_tables_equal_jax(cf, e, k):
    """From each package's own router, the same experts and the same
    tables (token_table bit for bit); from the same top-k inputs, the
    same three tables bit for bit."""
    jcfg, tcfg = _moe_cfgs(cf, e, k)
    jp = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(2), 16, jcfg.moe,
                                                   jnp.float32))
    x = np.random.default_rng(3).standard_normal((48, 16)).astype(np.float32)
    cap = jax_moe._capacity(48, jcfg.moe)
    jgate, jidx = _routing_jax(jp, x, jcfg.moe)
    jtables = [np.asarray(a) for a in jax_moe._dispatch_tables(jidx, jgate, e, cap)]

    router = torch.from_numpy(np.array(jp["router"]["kernel"]))
    probs = torch.softmax(torch.from_numpy(x) @ router, -1)
    gate, idx = moe._top_k(probs, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    table, gtable, frac, slot = moe._dispatch_tables(idx, gate, e, cap)
    np.testing.assert_array_equal(table.numpy(), jtables[0])
    np.testing.assert_allclose(gtable.numpy(), jtables[1], atol=1e-6)
    np.testing.assert_array_equal(frac.numpy(), jtables[2])

    same = moe._dispatch_tables(torch.from_numpy(np.array(jidx)).long(),
                                torch.from_numpy(np.array(jgate)), e, cap)
    for got, want in zip(same[:3], jtables):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    # assignments past an expert's capacity are dropped (the sentinel slot)
    assert bool((slot == e * cap).any()) == (cf < 1.0)


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    """A zero router gives every expert the same probability: both
    packages then take experts 0..k-1 for every token."""
    probs = np.full((5, 8), 1 / 8, np.float32)
    probs[1, 6] = probs[1, 2] = 0.2  # a tie above the rest
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    _, idx = moe._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == [0, 1, 2] and idx[1].tolist() == [2, 6, 0]


def test_moe_router_stays_float32_in_bf16():
    tcfg = reduced_for_smoke(get_config("moonshot-v1-16b-a3b")).with_(
        dtype="bfloat16", param_dtype="bfloat16")
    params = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    block = params["blocks"][0]["moe"]
    assert block["router"]["kernel"].dtype == torch.float32
    assert {block[w].dtype for w in ("w_in", "w_gate", "w_out")} == {torch.bfloat16}
    x = torch.randn((2, 5, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    out, aux = moe.apply_moe(block, x.bfloat16(), cfg=tcfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# decoder-only: MoE and VLM models


@pytest.mark.parametrize("name", list(CASES))
def test_forward_prefill_and_decode_match_jax(name):
    jcfg, japi, jparams, tapi, tparams = _models(name)
    batch = _batch(jcfg, 2, N_TOTAL)
    prompt = dict(batch, tokens=batch["tokens"][:, :N_PROMPT])
    toks = torch.from_numpy(batch["tokens"])

    jfull, jaux = japi.forward(jparams, batch, rules=RULES)
    tfull, aux = tapi.forward(tparams, _torch(batch))
    _close(tfull, jfull, f"{name} forward")
    _close(aux, jaux, f"{name} forward aux")
    assert (float(aux) > 0) == (jcfg.moe is not None)

    jlog, jcache = japi.prefill(jparams, prompt, rules=RULES, cache_len=N_TOTAL)
    tlog, tcache = tapi.prefill(tparams, _torch(prompt), cache_len=N_TOTAL)
    _close(tlog, jlog, f"{name} prefill logits")
    _check_cache(tcache, jcache, f"{name} prefill")

    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, rules=RULES))
    for t in range(N_PROMPT, N_TOTAL):
        jlog, jcache = jstep(jparams, jcache, batch["tokens"][:, t : t + 1])
        tlog, tcache = tapi.decode_step(tparams, tcache, toks[:, t : t + 1])
        _close(tlog, jlog, f"{name} decode step {t}")
    _check_cache(tcache, jcache, f"{name} after decode")


def test_vlm_prompt_shorter_than_its_patches_raises():
    _, _, _, tapi, tparams = _models("vlm")
    batch = _torch(_batch(CASES["vlm"][0], 1, 3))  # 3 tokens, 4 patch embeddings
    with pytest.raises(ValueError, match="shorter than its 4 patch embeddings"):
        tapi.prefill(tparams, batch)


POSITION_CASES = {"dense": _pair(), "swa": _pair(sliding_window=8),
                  "moe": CASES["moe top-2 of 4"]}


@pytest.mark.parametrize("name", sorted(POSITION_CASES))
def test_caller_positions_match_jax(name):
    """Two packed sequences of 12 in a row of 24 (positions 0..11 twice),
    and a row offset by 5: RoPE and the causal and window masks read the
    caller's positions."""
    jcfg, tcfg = POSITION_CASES[name]
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0)))
    tparams = convert.lm_params_from_numpy(jparams, tcfg, "cpu")
    toks = _batch(jcfg, 2, 24)["tokens"]
    positions = np.stack([np.tile(np.arange(12), 2), np.arange(5, 29)]).astype(np.int32)
    from repro.models import transformer as jax_tf

    want, want_aux = jax_tf.lm_forward(jparams, jnp.asarray(toks), cfg=jcfg, rules=RULES,
                                       positions=jnp.asarray(positions))
    got, aux = tapi.forward(tparams, {"tokens": torch.from_numpy(toks)},
                            positions=torch.from_numpy(positions))
    _close(got, want, f"{name} forward at caller positions")
    _close(aux, want_aux, f"{name} aux")
    default, _ = tapi.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert not torch.allclose(got[0, 12:], default[0, 12:], atol=1e-3)


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper)


WHISPER = _reduced("whisper-medium")


def _encdec_models():
    jcfg, tcfg = WHISPER
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0)))
    return jcfg, japi, jparams, tapi, convert.encdec_params_from_numpy(jparams, tcfg, "cpu")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_encdec_params_carry_across():
    """``enc_blocks``/``dec_blocks`` become per-layer lists of the JAX
    leaves; the port's own ``init`` gives every leaf the same shape."""
    jcfg, _, jparams, _, tparams = _encdec_models()
    assert len(tparams["enc_blocks"]) == jcfg.num_encoder_layers == 2
    assert len(tparams["dec_blocks"]) == jcfg.num_layers == 2
    np.testing.assert_array_equal(tparams["dec_blocks"][1]["xattn"]["wq"]["kernel"].numpy(),
                                  jparams["dec_blocks"]["xattn"]["wq"]["kernel"][1])
    ported = build_model(WHISPER[1]).init(torch.Generator().manual_seed(0), "cpu")
    got = {path: tuple(t.shape) for path, t in _flat(ported) if not path[0].endswith("blocks")}
    want = {path: a.shape for path, a in _flat(jparams) if not path[0].endswith("blocks")}
    for stack in ("enc_blocks", "dec_blocks"):
        for blk in ported[stack]:
            got.update({(stack,) + path: tuple(t.shape) for path, t in _flat(blk)})
        want.update({(stack,) + path: a.shape[1:] for path, a in _flat(jparams[stack])})
    assert got == want


def test_encode_matches_jax():
    jcfg, _, jparams, _, tparams = _encdec_models()
    frames = _batch(jcfg, 2, 4)["frames"]
    want = jax_encdec.encode(jparams, jnp.asarray(frames), cfg=jcfg, rules=RULES)
    got = encdec.encode(tparams, torch.from_numpy(frames), cfg=WHISPER[1])
    assert tuple(got.shape) == (2, jcfg.audio.num_frames, jcfg.d_model)
    _close(got, want, "encode")


@pytest.mark.parametrize("n_prompt", [N_PROMPT, 20])  # 20 > the reduced 16 frames
def test_encdec_forward_prefill_and_decode_match_jax(n_prompt):
    jcfg, japi, jparams, tapi, tparams = _encdec_models()
    n_total = n_prompt + 8
    batch = _batch(jcfg, 2, n_total)
    prompt = dict(batch, tokens=batch["tokens"][:, :n_prompt])
    toks = torch.from_numpy(batch["tokens"])

    jfull, _ = japi.forward(jparams, batch, rules=RULES)
    tfull, aux = tapi.forward(tparams, _torch(batch))
    _close(tfull, jfull, "encdec forward")
    assert float(aux) == 0.0

    jlog, jcache = japi.prefill(jparams, prompt, rules=RULES, cache_len=n_total)
    tlog, tcache = tapi.prefill(tparams, _torch(prompt), cache_len=n_total)
    _close(tlog, jlog, "encdec prefill logits")
    _check_cache(tcache, jcache, "encdec prefill")
    assert tcache["cross_k"].shape[2] == jcfg.audio.num_frames

    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, rules=RULES))
    for t in range(n_prompt, n_total):
        jlog, jcache = jstep(jparams, jcache, batch["tokens"][:, t : t + 1])
        tlog, tcache = tapi.decode_step(tparams, tcache, toks[:, t : t + 1])
        _close(tlog, jlog, f"encdec decode step {t}")
        _close(tlog, jfull[:, t], f"encdec decode step {t} vs the forward")
    _check_cache(tcache, jcache, "encdec after decode")


def test_encdec_decode_past_the_cache_raises():
    jcfg, _, _, tapi, tparams = _encdec_models()
    batch = _torch(_batch(jcfg, 1, 4))
    _, cache = tapi.prefill(tparams, batch, cache_len=5)
    _, cache = tapi.decode_step(tparams, cache, batch["tokens"][:, :1])
    with pytest.raises(ValueError, match="full"):
        tapi.decode_step(tparams, cache, batch["tokens"][:, :1])


# ---------------------------------------------------------------------------
# cross-attention through K4's contract


@pytest.mark.parametrize("s,t", [(5, 16), (16, 16), (20, 16)])
def test_cross_attention_matches_jax(s, t):
    """``apply_attention(kv_x=...)``: no mask, no window, no RoPE, S < T,
    S = T and S > T, through K4's plain version on the CPU."""
    jcfg, tcfg = _pair(sliding_window=4)  # a window the cross path must not apply
    jp = jax.tree.map(np.asarray, jax_attn.init_attention(jax.random.key(1), jcfg,
                                                          jnp.float32))
    rng = np.random.default_rng(2)
    x, kv_x = (rng.standard_normal((2, n, 64)).astype(np.float32) for n in (s, t))
    pos = np.broadcast_to(np.arange(s)[None], (2, s))
    enc_pos = np.broadcast_to(np.arange(t)[None], (2, t))
    want = jax_attn.apply_attention(jp, jnp.asarray(x), cfg=jcfg, rules=RULES,
                                    positions=jnp.asarray(pos), kv_x=jnp.asarray(kv_x),
                                    kv_positions=jnp.asarray(enc_pos))
    from repro_torch.layers import attention

    before = ops.flash_attention.launches
    got = attention.apply_attention(convert.params_from_numpy(jp, "cpu"),
                                    torch.from_numpy(x), cfg=tcfg,
                                    kv_x=torch.from_numpy(kv_x))
    assert ops.flash_attention.launches == before  # the plain version on the CPU
    _close(got, want, f"cross attention S={s} T={t}")


def test_flash_contract_takes_more_queries_than_keys_only_unmasked():
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.standard_normal((1, 2, n, 8)).astype(np.float32))
            for n in (9, 4))
    got = ops.flash_attention(q, k, k, causal=False, window=None)
    want = torch.softmax(q @ k.transpose(-1, -2) * 8 ** -0.5, -1) @ k
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    for causal, window in ((True, None), (False, 3)):
        with pytest.raises(ValueError, match="T >= S"):
            flash_attention_ref(q, k, k, causal=causal, window=window)


# ---------------------------------------------------------------------------
# the engine and the launcher


ENGINE_CASES = ["moonshot-v1-16b-a3b reduced", "llava-next-mistral-7b reduced", "whisper"]


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_greedy_tokens_equal_jax(name):
    if name == "whisper":
        jcfg, japi, jparams, tapi, tparams = _encdec_models()
    else:
        jcfg, japi, jparams, tapi, tparams = _models(name)
    batch = _batch(jcfg, 2, 12, seed=2)
    want = JaxServeEngine(api=japi, run=JaxRunConfig(), params=jparams).generate(
        batch, max_new_tokens=6)
    got = ServeEngine(api=tapi, params=tparams).generate(_torch(batch), max_new_tokens=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-medium"])
def test_make_batch_draws_in_the_jax_launchers_order(arch):
    """tokens, then patches, then frames from one numpy generator, as
    repro/launch/serve.py draws them."""
    cfg = reduced_for_smoke(get_config(arch))
    got = make_batch(cfg, seed=7, batch=2, prompt_len=12, device="cpu")
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  rng.integers(0, cfg.vocab_size, size=(2, 12)))
    key, shape = (("patches", (2, 8, 64)) if cfg.vision is not None
                  else ("frames", (2, 16, cfg.d_model)))
    assert sorted(got) == sorted(["tokens", key])
    assert got[key].dtype == torch.float32 and tuple(got[key].shape) == shape
    np.testing.assert_array_equal(got[key].numpy(),
                                  rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b",
                                  "qwen3-moe-235b-a22b", "llava-next-mistral-7b",
                                  "whisper-medium"])
def test_serve_cli_runs_each_new_family_reduced_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
         "--batch", "2", "--prompt-len", "20", "--max-new", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "generated (2, 4)" in r.stdout and "on cpu" in r.stdout
