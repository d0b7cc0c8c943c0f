"""Decoder-only transformer of the port: the dense, moe, ssm, hybrid and
vlm families, full forward, prefill into a decode cache, and one-token
decode.

Counterpart of ``repro/models/transformer.py``.  Params are a nested
dict of tensors in the JAX package's layouts, with ``blocks`` a list of
per-layer dicts where the JAX package stacks the layers on a leading
axis (``convert.lm_params_from_numpy`` maps one to the other).  The
full-sequence functions take the attention and SSD functions as
arguments, as ``models/cnn.py::cnn_forward`` takes its conv: by default
``kernels.ops.flash_attention`` (K4) and ``kernels.ops.ssd`` (K5), the
hand-written Hopper kernels on the card; their plain versions give the
same model in plain torch.  Under autograd both kernels carry gradients
(``FlashAttentionFunction``, ``SsdFunction``), and ``lm_forward`` takes
the JAX package's ``remat`` policies.  Decode launches neither kernel.  A MoE
block (``layers/moe.py``) takes the MLP's place; the VLM projector maps
the caller's patch embeddings onto the first positions of the sequence.
The encoder-decoder family is ``models/encdec.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention, ssd
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mamba2 as mamba_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers.embedding import embed_tokens, init_embedding, logits_from_embedding
from repro_torch.layers.linear import apply_dense, init_dense
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.norm import apply_norm, init_norm
from repro_torch.models.remat import remat_block


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


def _has_mamba(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _has_moe(cfg: ModelConfig) -> bool:
    return cfg.moe is not None


def _has_mlp(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm" and not _has_moe(cfg)


# ---------------------------------------------------------------------------
# params


def init_block(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    p: Dict[str, Any] = {"ln1": init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if _has_attn(cfg):
        p["attn"] = attn_lib.init_attention(generator, cfg, dtype, device)
    if _has_mamba(cfg):
        p["mamba"] = mamba_lib.init_mamba2(generator, cfg, dtype, device)
    if _has_moe(cfg):
        p["ln2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        p["moe"] = moe_lib.init_moe(generator, cfg.d_model, cfg.moe, dtype, device)
    elif _has_mlp(cfg):
        p["ln2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.gated_mlp, device=device)
    return p


def init_lm(generator: torch.Generator, cfg: ModelConfig, device):
    """Random params drawn from ``generator`` (on any device; drawing on
    the card is fast at full width), placed on ``device`` in
    ``cfg.param_dtype`` (a MoE router in float32).  Each tensor is drawn
    and placed before the next, so the transient is one tensor's float32
    draw."""
    dtype = getattr(torch, cfg.param_dtype)
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype, device),
        "blocks": [init_block(generator, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
        "ln_f": init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(generator, (cfg.d_model,), (cfg.vocab_size,), dtype,
                                  device=device)
    if cfg.vision is not None:
        v = cfg.vision
        p["projector"] = {
            "fc1": init_dense(generator, (v.vision_dim,), (v.projector_hidden,), dtype,
                              use_bias=True, device=device),
            "fc2": init_dense(generator, (v.projector_hidden,), (cfg.d_model,), dtype,
                              use_bias=True, device=device),
        }
    return p


# ---------------------------------------------------------------------------
# full sequence


def _fuse(lp, x: torch.Tensor, attn_out, mamba_out, *,
          cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A block's tail: hymba's attention and mamba heads, run in parallel
    on the same input, are fused by averaging; then the residual and the
    MLP or the MoE.  Returns (x, the MoE's aux loss or None)."""
    if attn_out is None or mamba_out is None:
        mix = mamba_out if attn_out is None else attn_out
    else:
        mix = 0.5 * (attn_out + mamba_out)
    x = x + mix
    aux = None
    if "ln2" in lp:
        h = apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
        if "moe" in lp:
            y, aux = moe_lib.apply_moe(lp["moe"], h, cfg=cfg)
        else:
            y = apply_mlp(lp["mlp"], h, cfg=cfg)
        x = x + y
    return x, aux


def apply_block(lp, x: torch.Tensor, *, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None,
                attention_fn=flash_attention,
                ssd_fn=ssd) -> Tuple[torch.Tensor, Dict, Optional[torch.Tensor]]:
    """Full-sequence block.  Returns (x, state, aux): the layer's k and v
    (B, S, KV, hd) and its mamba ``conv`` and ``ssm`` states, whichever
    the family has, for the prefill's cache; the MoE's aux loss or None.
    Caller-supplied ``positions`` (B, S) take the position-masked plain
    attention (``attn_lib.naive_attention``)."""
    h = apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
    state: Dict[str, torch.Tensor] = {}
    attn_out = mamba_out = None
    if _has_attn(cfg):
        q, state["k"], state["v"] = attn_lib.project_qkv(lp["attn"], h, cfg=cfg,
                                                         positions=positions)
        if positions is None:
            out = attn_lib.attend(q, state["k"], state["v"], causal=True,
                                  window=cfg.sliding_window, attention_fn=attention_fn)
        else:
            out = attn_lib.naive_attention(q, state["k"], state["v"], positions, positions,
                                           causal=True, window=cfg.sliding_window)
        attn_out = apply_dense(lp["attn"]["wo"], out, n_in_dims=2, dtype=cfg.compute_dtype)
    if _has_mamba(cfg):
        mamba_out, mamba_state = mamba_lib.mamba2_with_state(lp["mamba"], h, cfg=cfg,
                                                             ssd_fn=ssd_fn)
        state.update(mamba_state)
    x, aux = _fuse(lp, x, attn_out, mamba_out, cfg=cfg)
    return x, state, aux


def _head(params, x: torch.Tensor, cfg: ModelConfig, *, softcap: bool) -> torch.Tensor:
    dtype = cfg.compute_dtype
    x = apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = logits_from_embedding(params["embed"], x, dtype)
    else:
        logits = apply_dense(params["lm_head"], x, dtype=dtype)
    if softcap and cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           patches: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings; with ``patches`` (B, n_img, vision_dim) and a VLM
    config, the projector's output (fc1, tanh-approximated GELU as
    ``jax.nn.gelu``, fc2) takes the first n_img positions."""
    dtype = cfg.compute_dtype
    x = embed_tokens(params["embed"], tokens, dtype)
    if cfg.vision is None or patches is None:
        return x
    n_img = patches.shape[1]
    if tokens.shape[1] < n_img:
        raise ValueError(
            f"{cfg.arch_id}: a prompt of {tokens.shape[1]} tokens is shorter than its "
            f"{n_img} patch embeddings, which take its first positions")
    proj = F.gelu(apply_dense(params["projector"]["fc1"], patches.to(dtype), dtype=dtype),
                  approximate="tanh")
    proj = apply_dense(params["projector"]["fc2"], proj, dtype=dtype)
    return torch.cat([proj, x[:, n_img:]], dim=1)


def lm_forward(params, tokens: torch.Tensor, *, cfg: ModelConfig,
               patches: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None,
               attention_fn=flash_attention, ssd_fn=ssd,
               remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Train / prefill forward over a full sequence, at positions 0..S-1
    or at the caller's ``positions`` (B, S).  Returns (logits (B, S,
    vocab), aux): aux, the MoE balance loss summed over the layers (0
    without MoE), float32.  ``remat`` (``none | full | dots``) is each
    block's rematerialisation under autograd (``models/remat.py``)."""
    x = _embed(params, tokens, cfg, patches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(lp, xc):
        y, _, a = apply_block(lp, xc, cfg=cfg, positions=positions,
                              attention_fn=attention_fn, ssd_fn=ssd_fn)
        return y, (torch.zeros((), dtype=torch.float32, device=y.device)
                   if a is None else a)

    block = remat_block(block, remat)
    for lp in params["blocks"]:
        x, a = block(lp, x)
        aux = aux + a
    return _head(params, x, cfg, softcap=True), aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device="cpu"):
    """Decode cache sized for a ``seq_len`` context: per-layer tensors
    stacked on a leading layer axis, as in the JAX package.
    Sliding-window archs keep a window-sized ring ("pos" holds each
    slot's absolute position, -1 = empty), SSM archs O(1) state.  "t" is
    the next position, a Python int."""
    dtype = dtype or cfg.compute_dtype
    cache: Dict[str, Any] = {"t": 0}
    n_layers = cfg.num_layers
    if _has_attn(cfg):
        c = cache_len_for(cfg, seq_len)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache["k"] = torch.zeros((n_layers, batch, c, kv, hd), dtype=dtype, device=device)
        cache["v"] = torch.zeros((n_layers, batch, c, kv, hd), dtype=dtype, device=device)
        cache["pos"] = torch.full((batch, c), -1, dtype=torch.int32, device=device)
    if _has_mamba(cfg):
        st = mamba_lib.init_mamba2_state(cfg, batch, dtype, device)
        cache["conv"] = st["conv"][None].repeat(n_layers, 1, 1, 1)
        cache["ssm"] = st["ssm"][None].repeat(n_layers, 1, 1, 1, 1)
    return cache


def lm_prefill(params, tokens: torch.Tensor, *, cfg: ModelConfig,
               patches: Optional[torch.Tensor] = None, cache_len: Optional[int] = None,
               attention_fn=flash_attention, ssd_fn=ssd) -> Tuple[torch.Tensor, Any]:
    """Prefill: full forward + build the decode cache.  Returns
    (last-token logits (B, vocab), cache).  ``cache_len`` >= s leaves
    headroom for subsequent decode steps (defaults to s).  As in the JAX
    package, the prefill's logits take no soft cap."""
    dtype = cfg.compute_dtype
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, patches)
    cache = init_cache(cfg, b, cache_len or s, dtype, x.device)
    c = cache["k"].shape[2] if "k" in cache else 0
    n_fill = min(c, s)
    # the last n_fill tokens go to slot = pos % c (ring layout)
    fill_pos = torch.arange(s - n_fill, s, device=x.device)
    slots = fill_pos % c if c else fill_pos

    for layer, lp in enumerate(params["blocks"]):
        x, state, _ = apply_block(lp, x, cfg=cfg, attention_fn=attention_fn, ssd_fn=ssd_fn)
        if "k" in state:  # the cache is filled in place
            cache["k"][layer][:, slots] = state["k"][:, s - n_fill:]
            cache["v"][layer][:, slots] = state["v"][:, s - n_fill:]
        if "ssm" in state:  # the JAX package's _mamba_prefill
            cache["conv"][layer] = state["conv"]
            cache["ssm"][layer] = state["ssm"]

    cache["t"] = s
    if "pos" in cache:
        cache["pos"][:, slots] = fill_pos.to(torch.int32)
    return _head(params, x[:, -1:], cfg, softcap=False)[:, 0], cache


def lm_decode_step(params, cache, tokens: torch.Tensor, *,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (B, 1) -> (logits (B, vocab), cache).  The
    cache is updated in place (the ring slot, the SSM and conv states,
    "pos" and "t") and returned; the JAX package returns a new cache."""
    position = cache["t"]
    x = embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    index = 0
    if _has_attn(cfg):
        index = position % cache["k"].shape[2]
        cache["pos"][:, index] = position

    for layer, lp in enumerate(params["blocks"]):
        h = apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
        attn_out = mamba_out = None
        if _has_attn(cfg):
            attn_out = attn_lib.decode_attention(
                lp["attn"], h, cfg=cfg, cache_k=cache["k"][layer],
                cache_v=cache["v"][layer], kv_pos=cache["pos"], index=index,
                position=position)
        if _has_mamba(cfg):
            mamba_out, state = mamba_lib.decode_mamba2(
                lp["mamba"], h, {"conv": cache["conv"][layer], "ssm": cache["ssm"][layer]},
                cfg=cfg)
            cache["conv"][layer] = state["conv"]
            cache["ssm"][layer] = state["ssm"]
        x, _ = _fuse(lp, x, attn_out, mamba_out, cfg=cfg)

    cache["t"] = position + 1
    return _head(params, x, cfg, softcap=True)[:, 0], cache
