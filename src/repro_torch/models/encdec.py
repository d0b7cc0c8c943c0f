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

Under a mesh each function takes the JAX package's ``rules`` (and the
``mesh``, for the cache's layout): the params and cache are DTensors
(``encdec_axes``, ``encdec_cache_axes``), the residual stream and the
logits are pinned at the JAX package's points, and K4 runs on each
rank's shards.  Without a mesh they run as on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import (
    embed_tokens,
    embedding_axes,
    init_embedding,
    logits_from_embedding,
)
from repro_torch.layers.linear import apply_dense
from repro_torch.layers.mlp import apply_mlp, init_mlp, mlp_axes
from repro_torch.layers.norm import apply_norm, init_norm, norm_axes
from repro_torch.models.remat import remat_block
from repro_torch.models.transformer import shard_cache
from repro_torch.sharding.local import write_layer, write_slots
from repro_torch.sharding.partitioning import constrain


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


def _enc_block_axes(cfg: ModelConfig):
    return {
        "ln1": norm_axes(cfg.norm),
        "attn": attn_lib.attention_axes(cfg),
        "ln2": norm_axes(cfg.norm),
        "mlp": mlp_axes(gated=cfg.gated_mlp),
    }


def _dec_block_axes(cfg: ModelConfig):
    ax = _enc_block_axes(cfg)
    ax["ln_x"] = norm_axes(cfg.norm)
    ax["xattn"] = attn_lib.attention_axes(cfg)
    return ax


def encdec_axes(cfg: ModelConfig):
    """Logical axes of ``init_encdec``'s params; each block list holds one
    layer's axes (the JAX package's without its stacked ``layers``
    axis), which apply to every layer."""
    return {
        "embed": embedding_axes(),
        "enc_blocks": _enc_block_axes(cfg),
        "enc_ln_f": norm_axes(cfg.norm),
        "dec_blocks": _dec_block_axes(cfg),
        "dec_ln_f": norm_axes(cfg.norm),
    }


def _remat(fn, remat: str):
    """The JAX package's encoder-decoder checkpoints each layer whole
    under ``full`` and under ``dots`` alike."""
    return remat_block(fn, "full" if remat in ("full", "dots") else remat)


def encode(params, frames: torch.Tensor, *, cfg: ModelConfig,
           attention_fn=flash_attention, remat: str = "none", rules=None) -> torch.Tensor:
    """frames: (B, T_enc, d_model) stub frontend embeddings -> the
    encoder's output (B, T_enc, d_model): bidirectional self-attention
    at positions 0..T_enc-1 (RoPE, ``cfg.sliding_window``), then the MLP,
    in every layer; the final norm.  ``remat``: ``none | full | dots``."""
    def block(lp, xc):
        h = apply_norm(cfg.norm, lp["ln1"], xc, cfg.norm_eps)
        xc = xc + attn_lib.apply_attention(lp["attn"], h, cfg=cfg, causal=False,
                                           attention_fn=attention_fn, rules=rules)
        h = apply_norm(cfg.norm, lp["ln2"], xc, cfg.norm_eps)
        xc = xc + apply_mlp(lp["mlp"], h, cfg=cfg, rules=rules)
        return constrain(xc, rules, "batch", "act_seq", "act_embed")

    block = _remat(block, remat)
    x = constrain(frames.to(cfg.compute_dtype), rules, "batch", "act_seq", "act_embed")
    for lp in params["enc_blocks"]:
        x = block(lp, x)
    return apply_norm(cfg.norm, params["enc_ln_f"], x, cfg.norm_eps)


def _dec_block(lp, x: torch.Tensor, enc_out: torch.Tensor, *, cfg: ModelConfig,
               attention_fn, rules=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer over a full token sequence at positions 0..S-1.
    Returns (x, the layer's self k, v and cross k, v for the cache)."""
    dtype = cfg.compute_dtype
    h = apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn_lib.project_qkv(lp["attn"], h, cfg=cfg, rules=rules)
    out = attn_lib.attend(q, k, v, causal=True, window=cfg.sliding_window,
                          attention_fn=attention_fn, rules=rules)
    x = x + attn_lib.attn_out(lp["attn"], out, cfg=cfg, rules=rules)
    h = apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
    xk, xv = (attn_lib.pin_heads(t, rules)
              for t in attn_lib.compute_kv(lp["xattn"], enc_out, dtype))
    xq = attn_lib.pin_heads(apply_dense(lp["xattn"]["wq"], h, dtype=dtype), rules)
    out = attn_lib.attend(xq, xk, xv, causal=False, window=None, attention_fn=attention_fn,
                          rules=rules)
    x = x + attn_lib.attn_out(lp["xattn"], out, cfg=cfg, rules=rules)
    h = apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
    x = x + apply_mlp(lp["mlp"], h, cfg=cfg, rules=rules)
    x = constrain(x, rules, "batch", "act_seq", "act_embed")
    return x, {"k": k, "v": v, "cross_k": xk, "cross_v": xv}


def _logits(params, x: torch.Tensor, cfg: ModelConfig, rules=None,
            seq_axis: Optional[str] = "act_seq") -> torch.Tensor:
    x = apply_norm(cfg.norm, params["dec_ln_f"], x, cfg.norm_eps)
    logits = logits_from_embedding(params["embed"], x, cfg.compute_dtype)
    return constrain(logits, rules, "batch", seq_axis, "vocab")


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 cfg: ModelConfig, attention_fn=flash_attention,
                 remat: str = "none", rules=None) -> torch.Tensor:
    """Teacher-forced decoder over the full token sequence -> logits
    (B, S, vocab).  ``remat``: ``none | full | dots``."""
    def block(lp, xc, enc):
        return _dec_block(lp, xc, enc, cfg=cfg, attention_fn=attention_fn, rules=rules)[0]

    block = _remat(block, remat)
    x = embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    x = constrain(x, rules, "batch", "act_seq", "act_embed")
    for lp in params["dec_blocks"]:
        x = block(lp, x, enc_out)
    return _logits(params, x, cfg, rules)


def encdec_forward(params, batch, *, cfg: ModelConfig, attention_fn=flash_attention,
                   remat: str = "none", rules=None,
                   mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: batch ``frames`` and ``tokens`` -> (logits,
    aux = 0)."""
    enc_out = encode(params, batch["frames"], cfg=cfg, attention_fn=attention_fn,
                     remat=remat, rules=rules)
    logits = decode_train(params, batch["tokens"], enc_out, cfg=cfg,
                          attention_fn=attention_fn, remat=remat, rules=rules)
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


def encdec_cache_axes():
    """Logical axes of ``init_encdec_cache``'s entries ("t" is a Python int)."""
    return {
        "t": None,
        "k": ("layers", "batch", "cache_seq", "kv_heads", None),
        "v": ("layers", "batch", "cache_seq", "kv_heads", None),
        "pos": ("batch", "cache_seq"),
        "cross_k": ("layers", "batch", None, "kv_heads", None),
        "cross_v": ("layers", "batch", None, "kv_heads", None),
        "cross_pos": ("batch", None),
    }


def encdec_prefill(params, batch, *, cfg: ModelConfig, cache_len: Optional[int] = None,
                   attention_fn=flash_attention, rules=None,
                   mesh=None) -> Tuple[torch.Tensor, Any]:
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
    enc_out = encode(params, frames, cfg=cfg, attention_fn=attention_fn, rules=rules)
    t_enc = enc_out.shape[1]
    if t_enc != cfg.audio.num_frames:
        raise ValueError(f"{cfg.arch_id}: {t_enc} frames, the config's cache holds "
                         f"{cfg.audio.num_frames}")
    cache = shard_cache(init_encdec_cache(cfg, b, cache_len, dtype, enc_out.device),
                        encdec_cache_axes(), rules, mesh)
    x = embed_tokens(params["embed"], tokens, dtype)
    x = constrain(x, rules, "batch", "act_seq", "act_embed")
    first = torch.arange(s, device=x.device)
    for layer, lp in enumerate(params["dec_blocks"]):
        x, state = _dec_block(lp, x, enc_out, cfg=cfg, attention_fn=attention_fn,
                              rules=rules)
        write_slots(cache["k"], first, state["k"], dim=1, layer=layer)
        write_slots(cache["v"], first, state["v"], dim=1, layer=layer)
        write_layer(cache["cross_k"], layer, state["cross_k"])
        write_layer(cache["cross_v"], layer, state["cross_v"])
    write_slots(cache["pos"], first, first.to(torch.int32)[None].expand(b, -1), dim=1)
    enc_pos = torch.arange(t_enc, dtype=torch.int32, device=x.device)
    write_slots(cache["cross_pos"], enc_pos, enc_pos[None].expand(b, -1), dim=1)
    cache["t"] = s
    return _logits(params, x[:, -1:], cfg, rules, seq_axis=None)[:, 0], cache


def encdec_decode_step(params, cache, tokens: torch.Tensor, *, cfg: ModelConfig,
                       rules=None, mesh=None) -> Tuple[torch.Tensor, Any]:
    """One decode token against the self cache and the fixed cross k, v:
    tokens (B, 1) -> (logits (B, vocab), cache).  The cache is updated
    in place (slot ``t`` of every layer, "pos" and "t") and returned; the
    JAX package returns a new cache."""
    position = cache["t"]
    if position >= cache["k"].shape[2]:
        raise ValueError(f"{cfg.arch_id}: the cache's {cache['k'].shape[2]} slots are "
                         f"full (no ring in the encoder-decoder's cache)")
    write_slots(cache["pos"], position, position, dim=1)
    x = embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    x = constrain(x, rules, "batch", None, "act_embed")
    for layer, lp in enumerate(params["dec_blocks"]):
        h = apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
        x = x + attn_lib.decode_attention(
            lp["attn"], h, cfg=cfg, cache_k=cache["k"], cache_v=cache["v"],
            kv_pos=cache["pos"], index=position, position=position, layer=layer)
        h = apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
        x = x + attn_lib.cross_decode_attention(
            lp["xattn"], h, cfg=cfg, k=cache["cross_k"][layer], v=cache["cross_v"][layer],
            kv_positions=cache["cross_pos"])
        h = apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], h, cfg=cfg, rules=rules)
    cache["t"] = position + 1
    return _logits(params, x, cfg, rules, seq_axis=None)[:, 0], cache
