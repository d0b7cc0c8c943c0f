"""Gradients through the port's attention and SSD kernels (K4, K5):
``FlashAttentionFunction`` / ``flash_attention_vjp`` and ``SsdFunction``
/ ``ssd_vjp``, against ``torch.autograd.gradcheck`` in float64 and
against ``jax.vjp`` of the JAX package's training-path functions
(``blockwise_attention`` and ``naive_attention``, ``_ssd_chunked``) on
the same numpy inputs.

On CPU tensors the forward is each kernel's plain version and the
backward the vjp, as on the card the forward is the kernel
(tests/test_torch_gpu.py and chip_smoke.py's ``kernel_grad`` hold them
there).  Tolerances: gradcheck's defaults (eps 1e-6, atol 1e-5, rtol
1e-3) in float64; against ``jax.vjp`` in float32, atol = rtol = 1e-4
(the two sum in different orders; the cotangents are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jax_attn
from repro.layers import mamba2 as jax_mamba
from repro_torch.kernels import flash_attn, ops
from repro_torch.kernels.flash_attn import FlashAttentionFunction, flash_attention_vjp
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.kernels.ssd import SsdFunction, ssd_vjp

VJP_ATOL = VJP_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_tile(monkeypatch):
    """A query tile of 8 rows, so that small shapes cross tile edges."""
    monkeypatch.setattr(flash_attn, "VJP_TILE", 8)


def _attn_np(seed, b, h, kv, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)), rng.standard_normal((b, t, kv, d)),
            rng.standard_normal((b, t, kv, d)), rng.standard_normal((b, s, h, d)))


# (B, H, KV, S, T, D, causal, window): causal, windowed, unmasked, S < T,
# GQA, S > T without masks, and S = 13 / 21 (not a multiple of the tile)
ATTN_CASES = {
    "causal": (1, 2, 2, 16, 16, 4, True, None),
    "causal ragged tile": (1, 2, 2, 13, 13, 4, True, None),
    "window": (1, 2, 2, 21, 21, 4, True, 5),
    "unmasked": (2, 2, 2, 12, 12, 4, False, None),
    "S < T causal window": (1, 2, 2, 9, 20, 4, True, 6),
    "GQA 6/2 window": (1, 6, 2, 11, 11, 4, True, 4),
    "S > T unmasked": (1, 2, 1, 17, 7, 4, False, None),
}


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_attention_vjp_passes_gradcheck(name, small_tile):
    b, h, kv, s, t, d, causal, window = ATTN_CASES[name]
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2) for a in _attn_np(0, b, h, kv, s, t, d))
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal, window=window),
        (q, k, v))


@pytest.mark.parametrize("blockwise", [False, True], ids=["naive", "blockwise"])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_attention_vjp_matches_jax_vjp(name, blockwise, small_tile):
    """dq, dk, dv against ``jax.vjp`` of the JAX package's training-path
    attention, queries right-aligned (positions T - S + i) against keys
    0..T-1, on the (B, S, heads, D) layout the model hands both."""
    b, h, kv, s, t, d, causal, window = ATTN_CASES[name]
    q, k, v, g = (a.astype(np.float32) for a in _attn_np(1, b, h, kv, s, t, d))
    q_pos = np.broadcast_to(np.arange(s, dtype=np.int32) + (t - s), (b, s))
    kv_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    fn = jax_attn.blockwise_attention if blockwise else jax_attn.naive_attention
    kw = {"block_k": 4} if blockwise else {}
    def vjp(q_, k_, v_, g_):
        return jax.vjp(lambda *a: fn(*a, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                     causal=causal, window=window, **kw),
                       q_, k_, v_)[1](g_)

    want = jax.jit(vjp)(*(jnp.asarray(a) for a in (q, k, v, g)))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.transpose(1, 2).backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=VJP_ATOL, rtol=VJP_RTOL)


def test_flash_attention_vjp_returns_the_inputs_dtypes_and_shapes():
    """bf16 q, k, v (strided (B, H, S, D) views of (B, S, H, D) tensors)
    and a bf16 output give bf16 gradients of their shapes, each within
    one bf16 rounding of float64 autograd through the plain version
    (atol 1e-3, rtol 1e-2 against the reference rounded to bf16): O
    enters the vjp in float32, not as the bf16 output."""
    q, k, v, g = (torch.from_numpy(a.astype(np.float32))
                  for a in _attn_np(2, 1, 4, 2, 300, 300, 64))
    q16, k16, v16 = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
    g16 = g.to(torch.bfloat16).transpose(1, 2)
    out = flash_attention_ref(q16, k16, v16, causal=True, window=64)
    got = flash_attention_vjp(q16, k16, v16, out, g16, True, 64)
    refs = [x.double().requires_grad_(True) for x in (q16, k16, v16)]
    flash_attention_ref(*refs, causal=True, window=64).backward(g16.double())
    for x, gx, r in zip((q16, k16, v16), got, refs):
        assert gx.dtype == torch.bfloat16 and gx.shape == x.shape
        torch.testing.assert_close(gx.double(), r.grad.to(torch.bfloat16).double(),
                                   atol=1e-3, rtol=1e-2)


def test_flash_attention_builds_no_node_without_grad():
    """Serving: under ``no_grad`` and ``inference_mode`` the output has no
    autograd history, even for inputs that require grad; with grad on it
    comes from ``FlashAttentionFunction``."""
    q, k, v = (torch.randn(1, 2, 6, 4, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert ops.flash_attention(q, k, v).grad_fn is None
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert FlashAttentionFunction.apply(q, k, v, True, None).grad_fn is not None


def _ssd_np(seed, b, s, h, g, p, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))),
            -np.exp(rng.standard_normal(h) * 0.5),
            rng.standard_normal((b, s, g, n)), rng.standard_normal((b, s, g, n)),
            rng.standard_normal((b, s, h, p)), rng.standard_normal((b, h, p, n)))


# (B, S, H, G, P, N, chunk): G < H with a ragged last chunk, G = H, one chunk
SSD_CASES = {
    "G < H ragged": (1, 11, 4, 2, 3, 2, 4),
    "G = H": (2, 8, 2, 2, 2, 3, 4),
    "S < chunk": (1, 5, 2, 1, 2, 2, 8),
}


@pytest.mark.parametrize("outputs", ["y", "state", "both"])
@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_vjp_passes_gradcheck(name, outputs):
    b, s, h, g, p, n, chunk = SSD_CASES[name]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in _ssd_np(0, b, s, h, g, p, n)[:5]]
    pick = {"y": lambda r: r[0], "state": lambda r: r[1], "both": lambda r: r}[outputs]
    assert torch.autograd.gradcheck(lambda *a: pick(ops.ssd(*a, chunk=chunk)), tuple(ins))


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_vjp_matches_jax_vjp(name):
    """dx, ddt, da, dB, dC against ``jax.vjp`` of the JAX package's
    ``_ssd_chunked`` with cotangents on y and the final state."""
    b, s, h, g, p, n, chunk = SSD_CASES[name]
    x, dt, a, bm, cm, gy, gs = (arr.astype(np.float32) for arr in _ssd_np(1, b, s, h, g, p, n))
    def vjp(ins, cots):
        return jax.vjp(lambda *i: jax_mamba._ssd_chunked(*i, chunk), *ins)[1](cots)

    want = jax.jit(vjp)(tuple(jnp.asarray(arr) for arr in (x, dt, a, bm, cm)),
                        (jnp.asarray(gy), jnp.asarray(gs)))
    ins = [torch.from_numpy(arr).requires_grad_(True) for arr in (x, dt, a, bm, cm)]
    y, state = ops.ssd(*ins, chunk=chunk)
    torch.autograd.backward((y, state), (torch.from_numpy(gy), torch.from_numpy(gs)))
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=VJP_ATOL,
                                   rtol=VJP_RTOL)


def test_ssd_vjp_takes_no_cotangent_and_builds_no_node_without_grad():
    x, dt, a, bm, cm = (torch.from_numpy(arr.astype(np.float32))
                        for arr in _ssd_np(3, 1, 6, 2, 1, 2, 2)[:5])
    grads = ssd_vjp(x, dt, a, bm, cm, 4, None, None)
    assert all(torch.equal(gx, torch.zeros_like(t)) for gx, t in zip(grads, (x, dt, a, bm, cm)))
    xr = x.clone().requires_grad_(True)
    with torch.inference_mode():
        y, state = ops.ssd(xr, dt, a, bm, cm, chunk=4)
        assert y.grad_fn is None and state.grad_fn is None
    y, state = ops.ssd(xr, dt, a, bm, cm, chunk=4)
    assert type(y.grad_fn).__name__ == "SsdFunctionBackward"
    assert SsdFunction.apply(xr, dt, a, bm, cm, 4)[0].grad_fn is not None
