"""The port's attention and SSD kernels (K4, K5) and the model-zoo layers
that call them, against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package —
``flash_attention_pallas`` and ``ssd_pallas`` in interpret mode (the
kernel bodies run in Python on the CPU, as tests/test_kernels.py runs
them), its jnp oracles, and its layers — and through the port's kernel
wrappers, which, given CPU tensors, run their plain versions
(``flash_attention_ref``, ``ssd_chunked_ref``).  The hand-written CUDA
kernels run only on the card: tests/test_torch_gpu.py holds them against
these plain versions there.

Tolerances: the kernel sweeps use tests/test_kernels.py's (fp32 atol
2e-4, bf16 atol 5e-2, rtol 0.05; 10x the atol for the SSD scan, whose
chunked and sequential forms sum in different orders).  Layers compare
fp32 against fp32: atol 1e-5 on O(1) outputs (only summation orders
differ), 1e-4 where a d_model-wide contraction feeds an SSD scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attn import flash_attention_pallas
from repro.kernels.ssd import ssd_pallas
from repro.layers import attention as jax_attn
from repro.layers import embedding as jax_emb
from repro.layers import mamba2 as jax_mamba
from repro.layers import mlp as jax_mlp
from repro.layers import norm as jax_norm
from repro.models.registry import rules_for_mode
from repro_torch import convert
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd import ROW_TILE, ssd_plan
from repro_torch.layers import attention, embedding, mamba2, mlp, norm

RULES = rules_for_mode("megatron")
DTYPES = {
    "float32": (jnp.float32, torch.float32, 2e-4),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2),
}
LAYER_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


# ---------------------------------------------------------------------------
# K4: flash attention


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("s,t,d", [(32, 32, 16), (48, 80, 32), (17, 33, 8)])
def test_flash_plain_version_matches_pallas_and_oracle(s, t, d, causal, window, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    qn, kn, vn = _normal(0, 2, 2, s, d), _normal(1, 2, 2, t, d), _normal(2, 2, 2, t, d)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (qn, kn, vn)),
                              causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (2, 2, s, d)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (qn, kn, vn))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=16, block_k=16, interpret=True)
    oracle = jax_ref.flash_attention_ref(
        jq.astype(jnp.float32), jk.astype(jnp.float32), jv.astype(jnp.float32),
        causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32), atol=atol, rtol=0.05)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), atol=atol, rtol=0.05)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 6), (False, 6)])
def test_flash_plain_version_reads_gqa_heads_like_naive_attention(causal, window):
    """H = 6 query heads over KV = 2 kv heads, S < T: query head h reads
    kv head h // 3, as the JAX package's ``_split_gqa`` groups them."""
    b, s, t, h, kv, d = 2, 5, 12, 6, 2, 8
    qn, kn, vn = _normal(3, b, s, h, d), _normal(4, b, t, kv, d), _normal(5, b, t, kv, d)
    q_pos = np.broadcast_to(np.arange(t - s, t)[None], (b, s))
    kv_pos = np.broadcast_to(np.arange(t)[None], (b, t))
    want = jax_attn.naive_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                    causal=causal, window=window)
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in (qn, kn, vn))
    got = ops.flash_attention(q, k, v, causal=causal, window=window).transpose(1, 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


def test_flash_plain_version_is_the_kernels_cpu_path():
    qn, kn = _normal(6, 1, 2, 4, 8), _normal(7, 1, 2, 9, 8)
    q, k = torch.from_numpy(qn), torch.from_numpy(kn)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, k, causal=True, window=3)
    assert ops.flash_attention.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, flash_attention_ref(q, k, k, causal=True, window=3),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# K5: SSD chunked scan


def _ssd_inputs(seed, b, s, h, p, n, g=None):
    g = h if g is None else g
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,h,p,n,chunk", [(32, 2, 8, 4, 8), (48, 3, 16, 8, 16),
                                           (25, 1, 4, 4, 8)])
def test_ssd_plain_version_matches_pallas_and_oracle(s, h, p, n, chunk, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    x, dt, a, bm, cm = _ssd_inputs(0, 2, s, h, p, n)
    tx, tb, tc = (torch.from_numpy(v).to(tdt) for v in (x, bm, cm))
    y, final = ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc, chunk=chunk)
    assert y.dtype == tdt and tuple(y.shape) == (2, s, h, p)
    assert final.dtype == torch.float32 and tuple(final.shape) == (2, h, p, n)
    pallas = ssd_pallas(jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(a),
                        jnp.asarray(bm).astype(jdt), jnp.asarray(cm).astype(jdt),
                        chunk=chunk, interpret=True)
    y_ref, final_ref = jax_ref.ssd_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    np.testing.assert_allclose(_np(y), np.asarray(pallas, np.float32),
                               atol=10 * atol, rtol=0.05)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), atol=10 * atol, rtol=0.05)
    np.testing.assert_allclose(_np(final), np.asarray(final_ref), atol=10 * atol, rtol=0.05)


@pytest.mark.parametrize("s,h,g,chunk", [(48, 4, 2, 16), (20, 3, 1, 8), (7, 2, 2, 16)])
def test_ssd_plain_version_matches_ssd_chunked(s, h, g, chunk):
    """y and the final state against the JAX package's ``_ssd_chunked``
    with grouped B/C (head h reads group h // (H/G)), a ragged last
    chunk, and S shorter than one chunk; and against the port's own
    sequential oracle ``ssd_ref``."""
    x, dt, a, bm, cm = _ssd_inputs(1, 2, s, h, 8, 4, g)
    y, final = ops.ssd(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)), chunk=chunk)
    jy, jfinal = jax_mamba._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                                        chunk)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(final), np.asarray(jfinal), atol=1e-4, rtol=1e-4)
    sy, sfinal = ssd_ref(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)))
    torch.testing.assert_close(y, sy, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(final, sfinal, atol=1e-3, rtol=1e-3)


def test_ssd_chunk_is_cut_to_the_sequence():
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _ssd_inputs(2, 1, 5, 2, 4, 4))
    before = ops.ssd.launches
    y, final = ops.ssd(x, dt, a, bm, cm, chunk=256)
    assert ops.ssd.launches == before
    y5, final5 = ssd_chunked_ref(x, dt, a, bm, cm, 5)
    torch.testing.assert_close(y, y5, atol=0, rtol=0)
    torch.testing.assert_close(final, final5, atol=0, rtol=0)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (4, 2048, 50, 64, 16, 256),  # hymba's prefill
    (4, 2000, 50, 64, 16, 256),  # a ragged last chunk
    (1, 100, 3, 64, 16, 256),    # S < L
    (2, 700, 6, 20, 16, 256),
    (2, 25, 1, 4, 4, 8),         # chunks shorter than a row tile
    (1, 70, 4, 32, 128, 64),
    (1, 130, 2, 8, 4, 100),      # a chunk of two row tiles, the second ragged
])
def test_ssd_plan_covers_every_step_once(b, s, h, p, n, chunk):
    """K5's plan is a function of the shapes; its chunks and tiles cover
    every step exactly once, and no tile crosses a chunk's end."""
    plan = ssd_plan(b, s, h, p, n, chunk)
    assert plan == ssd_plan.__wrapped__(b, s, h, p, n, chunk)
    covered = np.zeros(s, int)
    for c in range(plan.chunks):
        for r in range(plan.row_tiles):
            lo = c * plan.chunk + r * ROW_TILE
            hi = min(lo + ROW_TILE, (c + 1) * plan.chunk, s)
            if lo < hi:
                covered[lo:hi] += 1
    assert (covered == 1).all()
    assert plan.chunk == min(chunk, s) and (plan.chunks - 1) * plan.chunk < s
    assert (plan.row_tiles - 1) * ROW_TILE < plan.chunk <= plan.row_tiles * ROW_TILE
    assert plan.tiles == plan.chunks * plan.row_tiles
    assert plan.ws_floats == b * h * plan.tiles * (2 * p * n + 1)


def test_ssd_plan_at_hymba_prefill():
    """hymba's prefill: 8 chunks of 4 tiles a (batch, head), 6,400 tiles
    in all for the tile passes' blocks to walk (their launch grid is held
    above B * H on the card by tests/test_torch_gpu.py)."""
    plan = ssd_plan(4, 2048, 50, 64, 16, 256)
    assert (plan.chunk, plan.chunks, plan.row_tiles, plan.tiles) == (256, 8, 4, 32)
    assert 4 * 50 * plan.tiles == 6400


# ---------------------------------------------------------------------------
# layers


def _cfgs(**kw):
    base = dict(arch_id="t", family="hybrid", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, head_dim=8, d_ff=48, vocab_size=61,
                sliding_window=6, dtype="float32", param_dtype="float32")
    base.update(kw)
    jcfg = JaxModelConfig(**base, ssm=JaxSSMConfig(d_state=4, d_conv=3, expand=2,
                                                  head_dim=8, chunk_size=8))
    tcfg = ModelConfig(**base, ssm=SSMConfig(d_state=4, d_conv=3, expand=2,
                                             head_dim=8, chunk_size=8))
    return jcfg, tcfg


def _tree(jax_params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")


@pytest.mark.parametrize("theta", [10000.0, 5e6])
def test_rope_matches(theta):
    x = _normal(0, 2, 7, 3, 16)
    pos = np.arange(7)[None].repeat(2, 0)
    want = jax_emb.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = embedding.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    x = _normal(1, 3, 5, 24) * 3 + 1
    p = {"scale": _normal(2, 24), "bias": _normal(3, 24)}
    if kind == "rmsnorm":
        del p["bias"]
    want = jax_norm.apply_norm(kind, jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-5)
    got = norm.apply_norm(kind, convert.params_from_numpy(p, "cpu"), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", False),
                                              ("squared_relu", False)])
def test_mlp_matches(activation, gated):
    jcfg, tcfg = _cfgs(activation=activation, gated_mlp=gated)
    jp = jax_mlp.init_mlp(jax.random.key(0), 32, 48, jnp.float32, gated=gated)
    x = _normal(4, 2, 5, 32)
    want = jax_mlp.apply_mlp(jp, jnp.asarray(x), cfg=jcfg, rules=RULES)
    got = mlp.apply_mlp(_tree(jp), torch.from_numpy(x), cfg=tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("window", [None, 6])
def test_apply_attention_matches(window):
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp = jax_attn.init_attention(jax.random.key(1), jcfg, jnp.float32)
    x = _normal(5, 2, 11, 32)
    pos = jnp.broadcast_to(jnp.arange(11)[None], (2, 11))
    want = jax_attn.apply_attention(jp, jnp.asarray(x), cfg=jcfg, rules=RULES, positions=pos)
    got = attention.apply_attention(_tree(jp), torch.from_numpy(x), cfg=tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


def test_apply_mamba2_matches():
    jcfg, tcfg = _cfgs()
    jp = jax_mamba.init_mamba2(jax.random.key(2), jcfg, jnp.float32)
    x = _normal(6, 2, 19, 32)  # 19 steps: two whole chunks of 8 and a ragged one
    want = jax_mamba.apply_mamba2(jp, jnp.asarray(x), cfg=jcfg, rules=RULES)
    got = mamba2.apply_mamba2(_tree(jp), torch.from_numpy(x), cfg=tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


def test_decode_mamba2_matches():
    jcfg, tcfg = _cfgs()
    jp = jax_mamba.init_mamba2(jax.random.key(3), jcfg, jnp.float32)
    state = {"conv": _normal(7, 2, 2, 64 + 8), "ssm": _normal(8, 2, 8, 8, 4)}
    x = _normal(9, 2, 1, 32)
    want, want_state = jax_mamba.decode_mamba2(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state), cfg=jcfg, rules=RULES)
    got, got_state = mamba2.decode_mamba2(
        _tree(jp), torch.from_numpy(x), convert.params_from_numpy(state, "cpu"), cfg=tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(_np(got_state[key]), np.asarray(want_state[key]),
                                   atol=LAYER_ATOL)
