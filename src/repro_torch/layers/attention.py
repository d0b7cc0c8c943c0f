"""Multi-head attention of the port: GQA, RoPE, sliding window,
cross-attention, and one-token decode against a ring KV cache.

Counterpart of ``repro/layers/attention.py``.  Full-sequence attention
(train, prefill, the encoder, cross-attention) goes through an
``attention_fn`` with the flash-attention contract — by default
``kernels.ops.flash_attention`` (K4, the hand-written Hopper kernel on
the card), where the JAX package runs its jnp ``attend``: the Pallas
kernel of ``repro/kernels/flash_attn.py`` implements the same contract.
That contract places query i at position i of its own sequence, which
is what positions 0..S-1 give; decode reads a ring of cache slots whose
positions are out of order, and a caller may supply positions of its
own (``models/transformer.py::lm_forward(positions=...)``), so both keep
the JAX package's ``naive_attention`` over explicit positions, in plain
torch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.layers.embedding import apply_rope
from repro_torch.layers.linear import apply_dense, init_dense

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype, device="cpu"):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": init_dense(generator, (d,), (h, hd), dtype, device=device),
        "wk": init_dense(generator, (d,), (kv, hd), dtype, device=device),
        "wv": init_dense(generator, (d,), (kv, hd), dtype, device=device),
        "wo": init_dense(generator, (h, hd), (d,), dtype, scale=1.0, device=device),
    }


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, KV, G, D)"""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """Reference attention. q: (B,S,H,D); k,v: (B,T,KV,D); positions
    (B,S)/(B,T).  kv slots with position < 0 are invalid (empty cache
    slots).  Computed in float32 (float64 stays float64), returned in
    q's dtype."""
    num_kv = k.shape[2]
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qg = _split_gqa(q, num_kv).to(acc_t)  # (B,S,KV,G,D)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(acc_t)) * scale
    mask = kv_pos[:, None, :] >= 0  # (B,1,T) valid slots
    if causal:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    # masked_fill takes the constant as a scalar: no host-to-card copy per call
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(acc_t))
    b, s = q.shape[:2]
    return out.reshape(b, s, q.shape[2], q.shape[3]).to(q.dtype)


def project_qkv(params, x: torch.Tensor, *, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None):
    """q (B,S,H,hd), k and v (B,S,KV,hd) of a full sequence, RoPE applied
    to q and k at ``positions`` (B,S) (0..S-1 if None), in the compute
    dtype."""
    dtype = cfg.compute_dtype
    q = apply_dense(params["wq"], x, dtype=dtype)
    k = apply_dense(params["wk"], x, dtype=dtype)
    v = apply_dense(params["wv"], x, dtype=dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None]
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attend(q, k, v, *, causal: bool, window: Optional[int],
           attention_fn=flash_attention) -> torch.Tensor:
    """Attention of a full sequence: q (B,S,H,hd), k and v (B,T,KV,hd) ->
    (B,S,H,hd), queries at positions 0..S-1 and keys at 0..T-1 (the
    flash contract's right alignment, for S == T or without masks).
    ``attention_fn`` takes the (B, heads, len, hd) views the
    flash-attention contract wants; K4 reads them through their
    strides, so the transposes copy nothing."""
    out = attention_fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal, window=window)
    return out.transpose(1, 2)


def compute_kv(params, kv_x: torch.Tensor, dtype):
    """Cross-attention k and v (B,T,KV,hd) of the encoder's output, no
    RoPE: the encoder-decoder's prefill computes them once per layer and
    caches them for decode."""
    return (apply_dense(params["wk"], kv_x, dtype=dtype),
            apply_dense(params["wv"], kv_x, dtype=dtype))


def apply_attention(params, x: torch.Tensor, *, cfg: ModelConfig, causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    attention_fn=flash_attention) -> torch.Tensor:
    """Full-sequence (train / prefill / encoder) attention: self-attention
    at positions 0..S-1 under ``causal`` and ``cfg.sliding_window``; with
    ``kv_x`` (B,T,d), cross-attention: no causal mask, no window, no RoPE
    on either side."""
    dtype = cfg.compute_dtype
    if kv_x is None:
        q, k, v = project_qkv(params, x, cfg=cfg)
        out = attend(q, k, v, causal=causal, window=cfg.sliding_window,
                     attention_fn=attention_fn)
    else:
        q = apply_dense(params["wq"], x, dtype=dtype)
        k, v = compute_kv(params, kv_x, dtype)
        out = attend(q, k, v, causal=False, window=None, attention_fn=attention_fn)
    return apply_dense(params["wo"], out, n_in_dims=2, dtype=dtype)


def decode_attention(params, x: torch.Tensor, *, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     kv_pos: torch.Tensor, index: int, position: int) -> torch.Tensor:
    """One-token decode against a KV cache, written in place.

    x: (B, 1, d).  cache_k/v: (B, L, KV, hd), L the full length or the
    sliding window (a ring).  kv_pos: (B, L), the absolute position in
    each slot (-1 = empty), already holding ``position`` at ``index``.
    The new token's k and v are written into slot ``index`` of cache_k
    and cache_v (the JAX package returns updated copies instead).
    Returns the layer's output (B, 1, d)."""
    dtype = cfg.compute_dtype
    b = x.shape[0]
    q = apply_dense(params["wq"], x, dtype=dtype)  # (B,1,H,hd)
    k = apply_dense(params["wk"], x, dtype=dtype)  # (B,1,KV,hd)
    v = apply_dense(params["wv"], x, dtype=dtype)
    pos_arr = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    cache_k[:, index] = k[:, 0].to(cache_k.dtype)
    cache_v[:, index] = v[:, 0].to(cache_v.dtype)
    out = naive_attention(q, cache_k.to(dtype), cache_v.to(dtype), pos_arr, kv_pos,
                          causal=True, window=cfg.sliding_window)
    return apply_dense(params["wo"], out, n_in_dims=2, dtype=dtype)


def cross_decode_attention(params, x: torch.Tensor, *, cfg: ModelConfig,
                           k: torch.Tensor, v: torch.Tensor,
                           kv_positions: torch.Tensor) -> torch.Tensor:
    """Cross-attention of one decode token (B,1,d) against the encoder's
    cached k and v (B,T,KV,hd): no mask but the slots' validity, no
    RoPE.  Returns (B,1,d)."""
    dtype = cfg.compute_dtype
    q = apply_dense(params["wq"], x, dtype=dtype)
    pos = torch.zeros((x.shape[0], 1), dtype=torch.int32, device=x.device)
    out = naive_attention(q, k.to(dtype), v.to(dtype), pos, kv_positions,
                          causal=False, window=None)
    return apply_dense(params["wo"], out, n_in_dims=2, dtype=dtype)
