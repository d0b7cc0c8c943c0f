"""Encoder-decoder transformer of the port (whisper-medium): the encoder
over the caller's frame embeddings, the causal decoder with
cross-attention into the encoder's output, prefill into a decode cache,
and one-token decode.

Counterpart of ``repro/models/encdec.py``.  The mel-spectrogram and
conv frontend is a stub there and here: the batch carries ``frames``
(B, T_enc, d_model) as the conv stack would emit them.  RoPE takes the
place of whisper's learned absolute positions, and the decoder's
embedding is tied with the logits head, as in the JAX package.  Params
are a nested dict of tensors with ``enc_blocks`` and ``dec_blocks``
lists of per-layer dicts (``convert.encdec_params_from_numpy``).

Every full-sequence attention goes through ``attention_fn``, by default
K4 (``kernels.ops.flash_attention``): the encoder's self-attention
(non-causal, S = T = T_enc), the decoder's causal self-attention, and
its cross-attention (non-causal, S = the prompt, T = T_enc; S may exceed
T).  The prefill computes each decoder layer's cross k and v once and
caches them, with the self-attention's k and v in a full cache (no
ring) of ``cache_len`` slots.  Decode launches no kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed_tokens, init_embedding, logits_from_embedding
from repro_torch.layers.linear import apply_dense
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.norm import apply_norm, init_norm
from repro_torch.models.remat import remat_block


def init_enc_block(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": attn_lib.init_attention(generator, cfg, dtype, device),
        "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp,
                        device=device),
    }


def init_dec_block(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": attn_lib.init_attention(generator, cfg, dtype, device),
        "ln_x": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "xattn": attn_lib.init_attention(generator, cfg, dtype, device),
        "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp,
                        device=device),
    }


def init_encdec(generator: torch.Generator, cfg: ModelConfig, device):
    """Random params drawn from ``generator``, placed on ``device`` in
    ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype, device),
        "enc_blocks": [init_enc_block(generator, cfg, dtype, device)
                       for _ in range(cfg.num_encoder_layers)],
        "enc_ln_f": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "dec_blocks": [init_dec_block(generator, cfg, dtype, device)
                       for _ in range(cfg.num_layers)],
        "dec_ln_f": init_norm(cfg.norm, cfg.d_model, dtype, device),
    }


def _remat(fn, remat: str):
    """The JAX package's encoder-decoder checkpoints each layer whole
    under ``full`` and under ``dots`` alike."""
    return remat_block(fn, "full" if remat in ("full", "dots") else remat)


def encode(params, frames: torch.Tensor, *, cfg: ModelConfig,
           attention_fn=flash_attention, remat: str = "none") -> torch.Tensor:
    """frames: (B, T_enc, d_model) stub frontend embeddings -> the
    encoder's output (B, T_enc, d_model): bidirectional self-attention
    at positions 0..T_enc-1 (RoPE, ``cfg.sliding_window``), then the MLP,
    in every layer; the final norm.  ``remat``: ``none | full | dots``."""
    def block(lp, xc):
        h = apply_norm(cfg.norm, lp["ln1"], xc, cfg.norm_eps)
        xc = xc + attn_lib.apply_attention(lp["attn"], h, cfg=cfg, causal=False,
                                           attention_fn=attention_fn)
        h = apply_norm(cfg.norm, lp["ln2"], xc, cfg.norm_eps)
        return xc + apply_mlp(lp["mlp"], h, cfg=cfg)

    block = _remat(block, remat)
    x = frames.to(cfg.compute_dtype)
    for lp in params["enc_blocks"]:
        x = block(lp, x)
    return apply_norm(cfg.norm, params["enc_ln_f"], x, cfg.norm_eps)


def _dec_block(lp, x: torch.Tensor, enc_out: torch.Tensor, *, cfg: ModelConfig,
               attention_fn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer over a full token sequence at positions 0..S-1.
    Returns (x, the layer's self k, v and cross k, v for the cache)."""
    dtype = cfg.compute_dtype
    h = apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn_lib.project_qkv(lp["attn"], h, cfg=cfg)
    out = attn_lib.attend(q, k, v, causal=True, window=cfg.sliding_window,
                          attention_fn=attention_fn)
    x = x + apply_dense(lp["attn"]["wo"], out, n_in_dims=2, dtype=dtype)
    h = apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
    xk, xv = attn_lib.compute_kv(lp["xattn"], enc_out, dtype)
    xq = apply_dense(lp["xattn"]["wq"], h, dtype=dtype)
    out = attn_lib.attend(xq, xk, xv, causal=False, window=None, attention_fn=attention_fn)
    x = x + apply_dense(lp["xattn"]["wo"], out, n_in_dims=2, dtype=dtype)
    h = apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
    x = x + apply_mlp(lp["mlp"], h, cfg=cfg)
    return x, {"k": k, "v": v, "cross_k": xk, "cross_v": xv}


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["dec_ln_f"], x, cfg.norm_eps)
    return logits_from_embedding(params["embed"], x, cfg.compute_dtype)


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 cfg: ModelConfig, attention_fn=flash_attention,
                 remat: str = "none") -> torch.Tensor:
    """Teacher-forced decoder over the full token sequence -> logits
    (B, S, vocab).  ``remat``: ``none | full | dots``."""
    def block(lp, xc, enc):
        return _dec_block(lp, xc, enc, cfg=cfg, attention_fn=attention_fn)[0]

    block = _remat(block, remat)
    x = embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    for lp in params["dec_blocks"]:
        x = block(lp, x, enc_out)
    return _logits(params, x, cfg)


def encdec_forward(params, batch, *, cfg: ModelConfig, attention_fn=flash_attention,
                   remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: batch ``frames`` and ``tokens`` -> (logits,
    aux = 0)."""
    enc_out = encode(params, batch["frames"], cfg=cfg, attention_fn=attention_fn,
                     remat=remat)
    logits = decode_train(params, batch["tokens"], enc_out, cfg=cfg,
                          attention_fn=attention_fn, remat=remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# serving


def init_encdec_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
                      device="cpu"):
    """A full self-attention cache of ``seq_len`` slots per layer ("pos":
    each slot's position, -1 = empty), the cross k and v of the
    encoder's ``cfg.audio.num_frames`` frames ("cross_pos": 0..T_enc-1
    once the prefill has run), and "t", the next position, a Python int."""
    dtype = dtype or cfg.compute_dtype
    n, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    t_enc = cfg.audio.num_frames
    return {
        "t": 0,
        "k": torch.zeros((n, batch, seq_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((n, batch, seq_len, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, seq_len), -1, dtype=torch.int32, device=device),
        "cross_k": torch.zeros((n, batch, t_enc, kv, hd), dtype=dtype, device=device),
        "cross_v": torch.zeros((n, batch, t_enc, kv, hd), dtype=dtype, device=device),
        "cross_pos": torch.zeros((batch, t_enc), dtype=torch.int32, device=device),
    }


def encdec_prefill(params, batch, *, cfg: ModelConfig, cache_len: Optional[int] = None,
                   attention_fn=flash_attention) -> Tuple[torch.Tensor, Any]:
    """Encode the batch's ``frames``, compute each decoder layer's cross
    k and v once, and prefill the ``tokens``.  Returns (last-token logits
    (B, vocab), cache); the cache holds ``cache_len`` (>= S, default S)
    self-attention slots, the first S filled."""
    dtype = cfg.compute_dtype
    frames, tokens = batch["frames"], batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"{cfg.arch_id}: cache_len {cache_len} < the prompt's {s} tokens")
    enc_out = encode(params, frames, cfg=cfg, attention_fn=attention_fn)
    t_enc = enc_out.shape[1]
    if t_enc != cfg.audio.num_frames:
        raise ValueError(f"{cfg.arch_id}: {t_enc} frames, the config's cache holds "
                         f"{cfg.audio.num_frames}")
    cache = init_encdec_cache(cfg, b, cache_len, dtype, enc_out.device)
    x = embed_tokens(params["embed"], tokens, dtype)
    for layer, lp in enumerate(params["dec_blocks"]):
        x, state = _dec_block(lp, x, enc_out, cfg=cfg, attention_fn=attention_fn)
        cache["k"][layer][:, :s] = state["k"]
        cache["v"][layer][:, :s] = state["v"]
        cache["cross_k"][layer] = state["cross_k"]
        cache["cross_v"][layer] = state["cross_v"]
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=x.device)
    cache["cross_pos"][:] = torch.arange(t_enc, dtype=torch.int32, device=x.device)
    cache["t"] = s
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def encdec_decode_step(params, cache, tokens: torch.Tensor, *,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """One decode token against the self cache and the fixed cross k, v:
    tokens (B, 1) -> (logits (B, vocab), cache).  The cache is updated
    in place (slot ``t`` of every layer, "pos" and "t") and returned; the
    JAX package returns a new cache."""
    position = cache["t"]
    if position >= cache["k"].shape[2]:
        raise ValueError(f"{cfg.arch_id}: the cache's {cache['k'].shape[2]} slots are "
                         f"full (no ring in the encoder-decoder's cache)")
    cache["pos"][:, position] = position
    x = embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    for layer, lp in enumerate(params["dec_blocks"]):
        h = apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
        x = x + attn_lib.decode_attention(
            lp["attn"], h, cfg=cfg, cache_k=cache["k"][layer], cache_v=cache["v"][layer],
            kv_pos=cache["pos"], index=position, position=position)
        h = apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
        x = x + attn_lib.cross_decode_attention(
            lp["xattn"], h, cfg=cfg, k=cache["cross_k"][layer], v=cache["cross_v"][layer],
            kv_positions=cache["cross_pos"])
        h = apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], h, cfg=cfg)
    cache["t"] = position + 1
    return _logits(params, x, cfg)[:, 0], cache
