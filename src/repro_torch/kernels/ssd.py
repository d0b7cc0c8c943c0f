"""Mamba-2 SSD chunked scan on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/ssd_fwd.cu`` (K5).

Counterpart of the Pallas TPU kernel ``repro/kernels/ssd.py::
ssd_pallas``, which walks the chunks of each (batch, head) in order with
an fp32 (P, N) state.  The kernel cuts each chunk into 64-step tiles and
runs every tile at once, in three passes: each tile's local state and
total decay into an fp32 workspace; per (batch, head) the state entering
each tile, a fixed-order fold of the earlier tiles' local states, and
the final state; per tile the carried state's inter term and the
masked-decay intra term of the tile's own causal triangle.  It returns
``ssd_pallas``'s y and also the final state, which the model's prefill
keeps for decode (the JAX package takes the same state from
``_ssd_chunked`` on that path).  B and C come with their groups
(B, S, G, N) and head h reads group h // (H/G); with G == H it is the
Pallas contract's pre-expanded layout.

What bounds it on an H100: at the model's widths about as many bytes
(x, B, C, dt read once, y written once) as the fp32 operations allow,
IEEE fp32 FMA on the CUDA cores (bf16 inputs widened as they are
staged).  Inputs are read through their strides (the model's slices of
its projection), staged by cp.async 16 bytes at a time where an fp32
operand is aligned; nothing is padded or expanded by a copy.

Tensors on the CPU go to the plain version (``ref.ssd_chunked_ref``);
CUDA tensors launch the kernel or raise — there is no fallback.
``ssd.launches`` counts the kernel's launches.

Training: with grad mode on and an input that requires grad, ``ssd``
goes through ``SsdFunction``, whose forward is the same kernel (or, on
CPU tensors, the plain version) and whose backward is ``ssd_vjp``.
Under ``no_grad`` / ``inference_mode`` (serving) no autograd node is
built.

Both paths call the kernel through a PyTorch operator,
``torch.ops.repro_torch.ssd_fwd`` (``ssd_op``): its fake gives the
outputs' shapes and dtypes, so DTensor shards (``local_map``) and
``FakeTensorMode`` go through it where they cannot go through the
ctypes launch, and its FLOP formula (``ssd_flops``, per 64-step tile)
is registered with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._build import ssd_fwd_library
from repro_torch.kernels.conv2d import _DTYPE_CODE, _count, _on_cpu, _raise_on
from repro_torch.kernels.ref import _acc_dtype, ssd_chunked_ref

MAX_HEAD_DIM = 128
# bytes of dynamic shared memory one block may use (the kernel's own
# limit: 227 KB less room for its static scratch)
MAX_SMEM = 232448 - 1024


# steps of a tile (the kernel's TILE)
ROW_TILE = 64


class SsdPlan(NamedTuple):
    """How K5 cuts one scan of S steps into chunks and 64-step tiles;
    the launcher takes ``row_tiles`` and ``tiles`` from here."""

    chunk: int  # steps per chunk: min(chunk, S)
    chunks: int  # ceil(S / chunk)
    row_tiles: int  # 64-step tiles of a chunk
    tiles: int  # chunks * row_tiles: the tiles of one (batch, head)
    ws_floats: int  # each tile's P x N local state and entering state, and total decay


@functools.lru_cache(maxsize=256)
def ssd_plan(b: int, s: int, h: int, p: int, n: int, chunk: int) -> SsdPlan:
    """K5's chunks, tiles and workspace for x (b, s, h, p), state size
    n, a function of the shapes alone.  The last chunk may be ragged; its
    tiles past S hold no step (pass 1 writes them a zero state, pass 3
    skips them).  Passes 1 and 3 walk the b * h * tiles tiles with one
    resident wave of blocks, as many as the card holds at once."""
    if min(b, s, h, p, n, chunk) < 1:
        raise ValueError(f"ssd_plan: want positive sizes, got {(b, s, h, p, n, chunk)}")
    chunk = min(chunk, s)
    chunks = -(-s // chunk)
    row_tiles = -(-chunk // ROW_TILE)
    tiles = chunks * row_tiles
    return SsdPlan(chunk, chunks, row_tiles, tiles, b * h * tiles * (2 * p * n + 1))


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
        cmat: torch.Tensor, *, chunk: int = 256):
    """x (B, S, H, P), dt (B, S, H) softplus'd, a (H,) negative, bmat and
    cmat (B, S, G, N) -> (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) float32).

    x, bmat and cmat all float32 or all bfloat16, dt and a float32, on one
    CUDA device (or all on the CPU); G dividing H; P <= 128.  The chunk
    is ``min(chunk, S)``, as in ``ssd_pallas``.  Differentiable
    (``SsdFunction``) where grad mode is on and an input requires grad."""
    ts = (x, dt, a, bmat, cmat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return SsdFunction.apply(x, dt, a, bmat, cmat, chunk)
    return ssd_op(x, dt, a, bmat, cmat, chunk)


def _ssd_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(x, dt, a, bmat, cmat):
        return ssd_chunked_ref(x, dt, a, bmat, cmat, min(chunk, x.shape[1]))
    ts = (x, dt, a, bmat, cmat)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(
            "ssd: operands must lie on one CUDA device (or all on the CPU), "
            f"got {[str(t.device) for t in ts]}"
        )
    if not (x.dtype == bmat.dtype == cmat.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"ssd: x, bmat and cmat must all be float32 or all bfloat16, got "
            f"{x.dtype}, {bmat.dtype} and {cmat.dtype}"
        )
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd: dt and a must be float32, got {dt.dtype} and {a.dtype}")
    if x.dim() != 4 or bmat.dim() != 4 or bmat.shape != cmat.shape:
        raise ValueError(
            f"ssd: want x (B,S,H,P) and bmat, cmat (B,S,G,N), got "
            f"{tuple(x.shape)}, {tuple(bmat.shape)} and {tuple(cmat.shape)}"
        )
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,)
            or tuple(bmat.shape[:2]) != (b, s) or g == 0 or h % g):
        raise ValueError(
            f"ssd: dt {tuple(dt.shape)}, a {tuple(a.shape)} or bmat "
            f"{tuple(bmat.shape)} do not fit x {tuple(x.shape)}"
        )
    if s == 0 or p == 0 or n == 0 or p > MAX_HEAD_DIM or chunk < 1:
        raise ValueError(f"ssd: want S, P, N, chunk >= 1 and P <= {MAX_HEAD_DIM}, "
                         f"got x {tuple(x.shape)}, N={n}, chunk={chunk}")
    plan = ssd_plan(b, s, h, p, n, chunk)
    chunk = plan.chunk
    lib = ssd_fwd_library()
    smem = lib.ssd_fwd_smem_bytes(p, n)
    if smem > MAX_SMEM:
        raise ValueError(
            f"ssd: head_dim {p} and d_state {n} need {smem} bytes of shared "
            f"memory per block, above {MAX_SMEM}"
        )
    x, dt, a, bmat, cmat = (_last_contiguous(t) for t in (x, dt, a, bmat, cmat))
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.ws_floats,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.ssd_fwd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(),
            b, s, h, g, p, n, chunk, plan.row_tiles, plan.tiles,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            bmat.stride(0), bmat.stride(1), bmat.stride(2),
            cmat.stride(0), cmat.stride(1), cmat.stride(2),
            _DTYPE_CODE[x.dtype], stream,
        )
    _raise_on(code, lib, "ssd_fwd_error_string",
              f"ssd_fwd for x {tuple(x.shape)} bmat {tuple(bmat.shape)} {x.dtype}")
    _count(ssd)
    return y, state


ssd.launches = 0


def ssd_flops(x_shape, bmat_shape, chunk: int, tile: int = ROW_TILE) -> float:
    """Operations of one SSD scan cut into chunks and, inside each, into
    tiles of ``tile`` steps: per tile of Lv steps, the causal triangle's
    Lv(Lv+1)/2 pairs each cost 2(N + P) (scores and scores x dt*x), the
    state and the inter term 2*Lv*P*N each."""
    b, s, h, p = x_shape
    n = bmat_shape[3]
    chunk = min(chunk, s)
    flops = 0.0
    for c0 in range(0, s, chunk):
        for t0 in range(c0, min(c0 + chunk, s), tile):
            lv = min(tile, c0 + chunk - t0, s - t0)
            flops += 2.0 * lv * (lv + 1) / 2 * (n + p) + 4.0 * lv * p * n
    return flops * b * h


@torch.library.custom_op("repro_torch::ssd_fwd", mutates_args=())
def ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
           cmat: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_ssd_forward`` (K5 on the card) as a PyTorch operator."""
    y, state = _ssd_forward(x, dt, a, bmat, cmat, chunk=chunk)
    return y, state


@ssd_op.register_fake
def _(x, dt, a, bmat, cmat, chunk):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, p, bmat.shape[3]), dtype=torch.float32))


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssd_fwd)
    def _flops(x_shape, dt_shape, a_shape, bmat_shape, cmat_shape, chunk, *args,
               out_shape=None, **kwargs):
        return ssd_flops(x_shape, bmat_shape, chunk)


_register_flops()


def ssd_vjp(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
            cmat: torch.Tensor, chunk: int, dy, dstate):
    """Gradients (dx, ddt, da, dbmat, dcmat) of ``ssd(x, dt, a, bmat,
    cmat, chunk=chunk)`` against the cotangents ``dy`` of y and
    ``dstate`` of the final state (either may be None), in the inputs'
    dtypes.

    The counterpart of ``jax.grad`` over the JAX package's
    ``repro/layers/mamba2.py::_ssd_chunked``: autograd differentiates a
    float32 recompute (float64 stays float64) of the same chunked form,
    ``ref.ssd_chunked_ref``, on the inputs widened as K5 widens them.
    It is called only from ``SsdFunction.backward``, never in place of
    K5's forward, and it is no port of a TPU kernel: no Pallas kernel of
    the repo computes this gradient."""
    ins = (x, dt, a, bmat, cmat)
    acc_t = _acc_dtype(*ins)
    with torch.enable_grad():
        leaves = [t.detach().to(acc_t).requires_grad_(True) for t in ins]
        y, state = ssd_chunked_ref(*leaves, min(chunk, x.shape[1]))
        outs, cots = [], []
        for o, c in ((y, dy), (state, dstate)):
            if c is not None:
                outs.append(o)
                cots.append(c.to(o.dtype))
        if not outs:
            return tuple(torch.zeros_like(t) for t in ins)
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g.to(t.dtype)
                 for g, t in zip(grads, ins))


class SsdFunction(torch.autograd.Function):
    """The SSD scan with a gradient: forward K5 (``_ssd_forward``; the
    plain version on CPU tensors) -> (y, final state), backward
    ``ssd_vjp``.  Saves the five inputs.  No path falls back to the plain
    version on the card."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk):
        y, state = ssd_op(x, dt, a, bmat, cmat, chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        with torch.profiler.record_function("ssd_vjp"):
            grads = ssd_vjp(*ctx.saved_tensors, ctx.chunk, dy, dstate)
        return (*grads, None)
