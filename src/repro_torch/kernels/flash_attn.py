"""Flash attention on Hopper: the wrapper of the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu`` (K4).

Counterpart of the Pallas TPU kernel ``repro/kernels/flash_attn.py::
flash_attention_pallas``, with its contract: q (B, H, S, D) against k, v
(B, KV, T, D), T >= S, queries right-aligned against the keys, causal
and sliding-window masks on absolute positions, fp32 softmax statistics,
the output in q's dtype.  KV may divide H (query head h reads kv head
h // (H/KV)); with KV == H it is the Pallas contract exactly.  Without
a causal mask or a window no score depends on where a query sits, so
there S may exceed T: the encoder-decoder's cross-attention, a prompt
longer than the encoder's frames.

What bounds it on an H100: 4*D operations per live (query, key) pair,
so operations.  The dtype picks the kernel: bf16 runs ``mma.sync`` on the
tensor cores (bound: the bf16 tensor-core rate), with P split into two
bf16 parts so that the output stays within one bf16 rounding of the fp32
reference; fp32 runs IEEE fp32 FMA on the CUDA cores (fp32 parity rules
out TF32; bound: the fp32 rate).  Fully masked kv tiles are never
visited, so a window W costs O(S*W).  Operands are read through their
strides: the model's (B, S, H, D) projections come in as
``transpose(1, 2)`` views, and the output is allocated (B, S, H, D) and
returned as the same kind of view, so neither side copies.

Tensors on the CPU go to the plain version (``ref.flash_attention_ref``);
CUDA tensors launch the kernel or raise — there is no fallback.
``flash_attention.launches`` counts the kernel's launches.

Training: with grad mode on and an input that requires grad,
``flash_attention`` goes through ``FlashAttentionFunction``, whose
forward is the same kernel (or, on CPU tensors, the plain version) and
whose backward is ``flash_attention_vjp``, written out in torch ops.
Under ``no_grad`` / ``inference_mode`` (serving) no autograd node is
built.

Both paths call the kernel through a PyTorch operator,
``torch.ops.repro_torch.flash_attention_fwd`` (``flash_attention_op``):
its fake gives the output's shape, strides and dtype, so DTensor shards
(``local_map``) and ``FakeTensorMode`` go through it where they cannot
go through the ctypes launch, and its FLOP formula
(``attention_flops``: 4*D per live pair) is registered with
``torch.utils.flop_counter``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._build import flash_attn_fwd_library
from repro_torch.kernels.conv2d import _DTYPE_CODE, _count, _on_cpu, _raise_on
from repro_torch.kernels.ref import (
    _acc_dtype,
    attention_mask,
    check_lengths,
    flash_attention_ref,
    ieee_fp32_matmul,
)

MAX_HEAD_DIM = 128
# query rows whose probabilities the backward recomputes at once
VJP_TILE = 256


def _row_strides(t: torch.Tensor):
    """(batch, head, row) element strides of a (B, H, S, D) operand whose
    last axis is contiguous (made so if it is not)."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1), t.stride(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """Online-softmax attention: q (B, H, S, D), k and v (B, KV, T, D) ->
    (B, H, S, D) in q's dtype.

    All three float32 or all bfloat16 on one CUDA device (or all on the
    CPU), S >= 1 and T >= 1, T >= S unless ``causal`` is False and
    ``window`` None, KV dividing H, D <= 128, ``window`` None or >= 1.
    Differentiable (``FlashAttentionFunction``) where grad mode is on and
    an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return flash_attention_op(q, k, v, causal, window)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if not (q.is_cuda and k.is_cuda and v.is_cuda
            and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: operands must lie on one CUDA device (or all "
            f"on the CPU), got {q.device}, {k.device} and {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention: q, k and v must all be float32 or all "
            f"bfloat16, got {q.dtype}, {k.dtype} and {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: want q (B,H,S,D) and k, v (B,KV,T,D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}"
        )
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(
            f"flash_attention: k, v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (same B and D, KV dividing H)"
        )
    check_lengths(s, t, causal, window)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} > {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    q, qsb, qsh, qss = _row_strides(q)
    k, ksb, ksh, kss = _row_strides(k)
    v, vsb, vsh, vss = _row_strides(v)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = flash_attn_fwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, s, t, d, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), 0 if window is None else int(window),
            _DTYPE_CODE[q.dtype], stream,
        )
    _raise_on(code, lib, "flash_attn_fwd_error_string",
              f"flash_attn_fwd for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    _count(flash_attention)
    return out


flash_attention.launches = 0


def live_pairs(s: int, t: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the masks leave live for one (batch, head):
    query i at position t - s + i sees keys max(0, pos - window + 1) ..
    pos (causal) or .. t - 1."""
    pos = np.arange(t - s, t, dtype=np.int64)
    hi = np.minimum(t - 1, pos) if causal else np.full_like(pos, t - 1)
    lo = np.maximum(0, pos - window + 1) if window is not None else np.zeros_like(pos)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_flops(q_shape, k_shape, causal: bool, window: Optional[int]) -> float:
    """Operations of one flash attention: 4*D per live (query, key) pair
    (q.k and p.v) of every (batch, head)."""
    b, h, s, d = q_shape
    return 4.0 * d * b * h * live_pairs(s, k_shape[2], causal, window)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: Optional[int]) -> torch.Tensor:
    """``_flash_forward`` (K4 on the card) as a PyTorch operator."""
    return _flash_forward(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    b, h, s, d = q.shape
    return q.new_empty((b, s, h, d)).transpose(1, 2)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
    def _flops(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs):
        return attention_flops(q_shape, k_shape, causal, window)


_register_flops()


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, causal: bool, window):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` = ``out``
    against the cotangent ``dout`` (B, H, S, D), in the inputs' dtypes
    and shapes, the kv heads' gradients summed over the query heads of
    their GQA group (head h reads kv head h // (H/KV)).

    Written out in torch ops: per tile of ``VJP_TILE`` query rows, P is
    recomputed in float32 (float64 stays float64) under the masks of
    ``ref.attention_mask`` (queries right-aligned against the keys), over
    the keys that some query of the tile may see (masked scores give
    P = 0, so the other keys add nothing), then dV += Pᵀ dO, dP = dO Vᵀ,
    dS = P ∘ (dP − rowsum(dO ∘ O)), dQ = dS K · scale, dK += dSᵀ Q · scale.
    bf16 inputs are widened first, and the products run in IEEE fp32 on
    the card.  O enters rowsum(dO ∘ O) in float32: ``out`` where it is
    already float32 (or float64), else P V recomputed in the tile, since
    a bf16 ``out`` moves dQ and dK by ~0.2% of their largest value.
    Memory: O(B·H·tile·T) per call, never the whole (S, T) matrix.

    This is no port of a TPU kernel: no Pallas kernel of the repo
    computes this gradient (the JAX package differentiates its jnp
    attention with ``jax.grad``), and it is not K4's plain version
    either, which is ``ref.flash_attention_ref``."""
    acc_t = _acc_dtype(q, k, v)
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    group = h // kv
    scale = d ** -0.5
    kf = k.to(acc_t).repeat_interleave(group, dim=1)
    vf = v.to(acc_t).repeat_interleave(group, dim=1)
    dof = dout.to(acc_t)
    # rowsum(dO ∘ O): the softmax's Jacobian term, one per query row, from
    # a float32 O (recomputed per tile where ``out`` is narrower)
    delta = (dof * out).sum(-1) if out.dtype == acc_t else None
    mask = attention_mask(s, t, causal, window, q.device)
    dq = torch.empty((b, h, s, d), dtype=acc_t, device=q.device)
    dk = torch.zeros((b, h, t, d), dtype=acc_t, device=q.device)
    dv = torch.zeros((b, h, t, d), dtype=acc_t, device=q.device)
    with ieee_fp32_matmul(q.device):
        for i0 in range(0, s, VJP_TILE):
            i1 = min(i0 + VJP_TILE, s)
            # keys some query of the tile may see: positions t - s + i
            lo = max(0, t - s + i0 - window + 1) if window is not None else 0
            hi = min(t, t - s + i1) if causal else t
            qt = q[:, :, i0:i1].to(acc_t)
            dot = dof[:, :, i0:i1]
            kt, vt = kf[:, :, lo:hi], vf[:, :, lo:hi]
            scores = (qt @ kt.transpose(-1, -2)) * scale
            scores = scores.masked_fill(~mask[i0:i1, lo:hi], -1e30)
            p = torch.softmax(scores, dim=-1)
            del scores
            dv[:, :, lo:hi] += p.transpose(-1, -2) @ dot
            row = (delta[:, :, i0:i1] if delta is not None
                   else (dot * (p @ vt)).sum(-1))
            ds = p * ((dot @ vt.transpose(-1, -2)) - row[..., None])
            del p
            dq[:, :, i0:i1] = (ds @ kt) * scale
            dk[:, :, lo:hi] += (ds.transpose(-1, -2) @ qt) * scale
    dk = dk.reshape(b, kv, group, t, d).sum(2)
    dv = dv.reshape(b, kv, group, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with a gradient: forward K4 (``_flash_forward``; the
    plain version on CPU tensors), backward ``flash_attention_vjp``.
    Saves q, k, v and the output.  No path falls back to the plain
    version on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = flash_attention_op(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_vjp(q, k, v, out, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None
