"""SAME stride-1 conv2d on Hopper: the wrappers of the hand-written CUDA
kernels ``csrc/conv2d_fwd.cu`` (forward) and ``csrc/conv2d_bwd.cu``
(dX and dW), and the differentiable conv built from them.

Counterparts of the Pallas TPU kernels of ``repro/kernels/conv2d.py``:
``conv2d`` of ``conv2d_pallas``, ``conv2d_dx`` of ``conv2d_dx_pallas``,
``conv2d_dw`` of ``conv2d_dw_pallas``, and ``Conv2dFunction`` of the
``pconv`` custom VJP in ``repro/core/backends.py``.  Tensors on the CPU
go to the plain versions (``ref.py``); CUDA tensors launch the kernel or
raise — there is no fallback.  Each wrapper's ``.launches`` counts its
kernel's launches, so a run can show that its path went through it.

Each kernel is also a PyTorch operator, ``torch.ops.repro_torch.conv2d_fwd``,
``conv2d_dx`` and ``conv2d_dw`` (``conv2d_op``, ``conv2d_dx_op``,
``conv2d_dw_op``), which ``Conv2dFunction`` calls: each fake gives the
output's shape and dtype, so DTensor shards (``local_map``) and
``FakeTensorMode`` go through them where they cannot go through the
ctypes launch, and their FLOP formula (``conv_flops``, 2*B*H*W*kh*kw*
Cin*Cout) is what a ``torch.utils.flop_counter`` registry reads.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels._build import conv2d_bwd_library, conv2d_fwd_library
from repro_torch.kernels.ref import conv2d_dw_ref, conv2d_dx_ref, conv2d_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()
# K1's and K2's split-K workspaces (fp32, one slice per split) stay within
# this many times the output's own bytes
_SPLIT_WS_CAP = 8
# K1 makes at most one split per this many products of each output
# (kh*kw*Cin): a split costs a round trip of 8 fp32 bytes per output
# through the workspace, the time of some 80 FMAs per output on the card
_FWD_MIN_SPLIT_K = 256
# K3's pixel chunks hold at least this many 8-pixel slabs (256 pixels,
# one DW_FOLD), and its fp32 workspace at most this many times the bytes
# of x, g and dW together: the sum of the chunks never reads more than a
# small multiple of what the GEMM itself moves
_DW_MIN_CHUNK_SLABS = 32
_DW_WS_CAP = 2
# blocks resident on one SM (the kernels' __launch_bounds__): K1 and K3
# (fp32) and K2's tiled variant, and K2's small-Cin variant by its N tile
_TILED_BLOCKS_PER_SM = 2
_DX_BLOCKS_PER_SM = {"tiled": _TILED_BLOCKS_PER_SM, 4: 2, 8: 1, 16: 1}


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check(name: str, a: torch.Tensor, b: torch.Tensor, kh: int, kw: int) -> None:
    """The kernels' common contract: one CUDA device, 4-d operands of
    one dtype (float32 or bfloat16), odd kernels."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(
            f"{name}: operands must lie on one CUDA device (or all on the "
            f"CPU), got {a.device} and {b.device}"
        )
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"{name}: odd kernels only, got {kh}x{kw}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"{name}: operands must both be float32 or both bfloat16, got "
            f"{a.dtype} and {b.dtype}"
        )


def _raise_on(code: int, lib, err_fn: str, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{getattr(lib, err_fn)(code).decode()} (cudaError {code})"
        )


def _count(fn) -> None:
    with _COUNT_LOCK:
        fn.launches += 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _least_cost_split(tiles: int, slots: int, steps: int, most: int) -> int:
    """The count of splits, 1 to ``most``, of a K loop of ``steps`` whole
    steps that minimises (waves of ``tiles`` x splits blocks over
    ``slots`` resident block slots) x (steps per split); the fewest splits
    on a tie, so a shape whose tiles already fill the slots does not split."""
    return min(range(1, max(1, most) + 1),
               key=lambda s: (-(-tiles * s // slots) * -(-steps // s), s))


class FwdPlan(NamedTuple):
    """How K1 cuts one forward GEMM (M = B*H*W pixels, N = Cout, K = kh*kw*Cin)."""

    bn: int  # output channels per block: the N tile (64 or 128)
    tiles: int  # blocks per split
    splits: int  # runs of taps, each its own workspace slice
    taps_per_split: int


@functools.lru_cache(maxsize=1024)
def fwd_plan(x_shape, kh: int, kw: int, cout: int, itemsize: int,
             sm_count: int) -> FwdPlan:
    """K1's tile and split of the taps, a function of the shapes alone (so
    a rerun sums in the same order).

    Tiles of 128 pixels by 128 channels, or 64 at Cout <= 64.  The kh*kw
    taps are split into runs of whole taps where that shortens the
    kernel, as ``dx_plan`` splits K2's: the count minimises (waves over
    the card's resident block slots) x (taps per split), the fewest on a
    tie, with the fp32 workspace at most ``_SPLIT_WS_CAP`` times y's bytes
    (y in x's dtype of ``itemsize`` bytes) and at most one split per
    ``_FWD_MIN_SPLIT_K`` products.  Where K is too short to split (C1,
    K = 75), the tiles are 64 channels wide if that lowers (waves) x
    (tile width): twice the blocks, each doing half the work, on a card
    that 128-wide tiles would leave mostly idle."""
    b, h, wd, cin = x_shape
    taps = kh * kw
    if b * h * wd == 0 or cin == 0 or cout == 0:
        raise ValueError(f"fwd_plan: nothing to compute for x {tuple(x_shape)} -> {cout}")
    slots = _TILED_BLOCKS_PER_SM * sm_count
    m_tiles = -(-b * h * wd // 128)
    most = min(taps, _SPLIT_WS_CAP * itemsize // 4, taps * cin // _FWD_MIN_SPLIT_K)
    if cout <= 64:
        bn = 64
    elif most <= 1:
        bn = min((128, 64), key=lambda n: (-(-m_tiles * -(-cout // n) // slots) * n, -n))
    else:
        bn = 128
    tiles = m_tiles * -(-cout // bn)
    splits = _least_cost_split(tiles, slots, taps, most)
    per = -(-taps // splits)
    return FwdPlan(bn, tiles, -(-taps // per), per)


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC SAME conv, stride 1, in x's dtype.

    x: (B, H, W, Cin) and w: (kh, kw, Cin, Cout), both float32 or both
    bfloat16, on one CUDA device; kh and kw odd.  Accumulates in fp32.
    An empty output (B, H or Cout of 0) is returned without a launch, and
    so is Cin = 0, whose y is zeros.  Non-contiguous inputs (a weight
    shard sliced on its last axis) are made contiguous first.
    ``fwd_plan`` picks the tile and the split of the taps; split partial
    sums are reduced in a fixed order, no atomics, so a rerun gives the
    same bits."""
    if _on_cpu(x, w):
        return conv2d_ref(x, w)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(
            f"conv2d: want x (B,H,W,Cin) and w (kh,kw,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    kh, kw, cin, cout = w.shape
    _check("conv2d", x, w, kh, kw)
    b, h, wd, _ = x.shape
    if cin == 0:
        return torch.zeros((b, h, wd, cout), dtype=x.dtype, device=x.device)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    x = x.contiguous()
    w = w.contiguous()
    plan = fwd_plan(x.shape, kh, kw, cout, x.element_size(), _sm_count(x.device))
    ws = (torch.empty((plan.splits, *y.shape), dtype=torch.float32, device=x.device)
          if plan.splits > 1 else None)
    lib = conv2d_fwd_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.conv2d_fwd_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, h, wd, cin, cout, kh, kw, plan.bn, plan.splits, plan.taps_per_split,
            _DTYPE_CODE[x.dtype], stream,
        )
    _raise_on(code, lib, "conv2d_fwd_error_string",
              f"conv2d_fwd for x {tuple(x.shape)} w {tuple(w.shape)} {x.dtype}")
    _count(conv2d)
    return y


def conv_flops(x_shape, w_shape) -> float:
    """Operations of one SAME stride-1 conv (or of its dX or dW):
    2*B*H*W*kh*kw*Cin*Cout."""
    b, h, wd, _ = x_shape
    kh, kw, cin, cout = w_shape
    return 2.0 * b * h * wd * kh * kw * cin * cout


@torch.library.custom_op("repro_torch::conv2d_fwd", mutates_args=())
def conv2d_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv2d`` (K1 on the card) as a PyTorch operator."""
    return conv2d(x, w)


@conv2d_op.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:3], w.shape[3]))


class DxPlan(NamedTuple):
    """How K2 cuts one dX GEMM (M = B*H*W pixels, N = Cin, K = kh*kw*Cout)."""

    variant: str  # "small_cin" (Cin <= 16) or "tiled"
    bn: int  # input channels per block: the N tile
    tiles: int  # blocks per split
    splits: int  # runs of taps, each its own workspace slice
    taps_per_split: int


@functools.lru_cache(maxsize=1024)
def dx_plan(g_shape, kh: int, kw: int, cin: int, itemsize: int,
            sm_count: int) -> DxPlan:
    """K2's variant, tile and split of the taps, a function of the shapes
    alone (so a rerun sums in the same order).

    Cin <= 16 takes the small-Cin variant with the N tile Cin rounded up
    to 4, 8 or 16 and 16 row segments of 8 pixels a block (4 at 16
    channels); larger Cin the tiled variant, 128 pixels by 64 (Cin <= 64)
    or 128 channels.  The kh*kw taps are split into runs of whole taps
    where that shortens the kernel: the count of splits minimises
    (waves of blocks over the card's resident block slots) x (taps per
    split), the fewest splits on a tie, with the fp32 workspace at most
    ``_SPLIT_WS_CAP`` times dX's bytes (dX in g's dtype of ``itemsize``
    bytes).  A shape whose tiles already fill the slots does not split."""
    b, h, wd, _ = g_shape
    taps = kh * kw
    if b * h * wd == 0:
        raise ValueError(f"dx_plan: no pixels in {tuple(g_shape)}")
    if cin <= 16:
        bn = 4 if cin <= 4 else 8 if cin <= 8 else 16
        seg = 4 if bn == 16 else 8
        variant, per_sm = "small_cin", _DX_BLOCKS_PER_SM[bn]
        tiles = -(-b * h * -(-wd // seg) // 16)
    else:
        variant, bn = "tiled", 64 if cin <= 64 else 128
        per_sm = _DX_BLOCKS_PER_SM["tiled"]
        tiles = -(-b * h * wd // 128) * -(-cin // bn)
    most = min(taps, _SPLIT_WS_CAP * itemsize // 4)
    splits = _least_cost_split(tiles, per_sm * sm_count, taps, most)
    per = -(-taps // splits)
    return DxPlan(variant, bn, tiles, -(-taps // per), per)


def conv2d_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX of the SAME stride-1 conv: g (B, H, W, Cout) against the
    forward kernel w (kh, kw, Cin, Cout) -> (B, H, W, Cin) in g's dtype.

    Same contract as ``conv2d``.  An empty output returns without a
    launch, and so does Cout = 0, whose dX is zeros.  ``dx_plan`` picks
    the kernel's variant and split; split partial sums are reduced in a
    fixed order, no atomics, so a rerun gives the same bits."""
    if _on_cpu(g, w):
        return conv2d_dx_ref(g, w)
    if g.dim() != 4 or w.dim() != 4 or w.shape[3] != g.shape[3]:
        raise ValueError(
            f"conv2d_dx: want g (B,H,W,Cout) and w (kh,kw,Cin,Cout), got "
            f"{tuple(g.shape)} and {tuple(w.shape)}"
        )
    kh, kw, cin, cout = w.shape
    _check("conv2d_dx", g, w, kh, kw)
    b, h, wd, _ = g.shape
    if b * h * wd * cin == 0 or cout == 0:
        return torch.zeros((b, h, wd, cin), dtype=g.dtype, device=g.device)
    dx = torch.empty((b, h, wd, cin), dtype=g.dtype, device=g.device)
    g = g.contiguous()
    w = w.contiguous()
    plan = dx_plan(g.shape, kh, kw, cin, g.element_size(), _sm_count(g.device))
    ws = (torch.empty((plan.splits, *dx.shape), dtype=torch.float32, device=g.device)
          if plan.splits > 1 else None)
    lib = conv2d_bwd_library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        code = lib.conv2d_dx_launch(
            g.data_ptr(), w.data_ptr(), dx.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, h, wd, cin, cout, kh, kw, plan.bn, plan.splits, plan.taps_per_split,
            _DTYPE_CODE[g.dtype], stream,
        )
    _raise_on(code, lib, "conv2d_bwd_error_string",
              f"conv2d_dx for g {tuple(g.shape)} w {tuple(w.shape)} {g.dtype}")
    _count(conv2d_dx)
    return dx


class DwPlan(NamedTuple):
    """How K3 cuts one dW GEMM (M = kh*kw*Cin, N = Cout, K = B*H*W pixels)."""

    bn: int  # output channels per block: the N tile (64 or 128)
    tiles: int  # blocks per chunk
    splits: int  # pixel chunks, each its own workspace slice
    chunk: int  # pixels per chunk: whole 8-pixel slabs


@functools.lru_cache(maxsize=1024)
def dw_plan(x_shape, kh: int, kw: int, cout: int, itemsize: int,
            sm_count: int) -> DwPlan:
    """K3's tile and split of the pixel axis, a function of the shapes
    alone (so a rerun sums in the same order).

    Tiles of 128 dW rows by 64 (Cout <= 64) or 128 channels.  The pixels
    are cut into chunks of whole 8-pixel slabs: the count minimises
    (waves over the card's resident block slots) x (slabs per chunk), the
    fewest on a tie, with at least ``_DW_MIN_CHUNK_SLABS`` slabs a chunk
    and the fp32 workspace at most ``_DW_WS_CAP`` times the bytes of x
    and g (of ``itemsize`` bytes) and dW together."""
    b, h, wd, cin = x_shape
    pixels = b * h * wd
    if pixels == 0 or cin == 0 or cout == 0:
        raise ValueError(f"dw_plan: nothing to compute for x {tuple(x_shape)} -> {cout}")
    bn = 64 if cout <= 64 else 128
    tiles = -(-kh * kw * cin // 128) * -(-cout // bn)
    slabs = -(-pixels // 8)
    dw_bytes = 4 * kh * kw * cin * cout
    ws_slices = _DW_WS_CAP * (itemsize * pixels * (cin + cout) + dw_bytes) // dw_bytes
    most = min(slabs // _DW_MIN_CHUNK_SLABS, ws_slices, 65535)
    splits = _least_cost_split(tiles, _TILED_BLOCKS_PER_SM * sm_count, slabs, most)
    per = -(-slabs // splits)
    return DwPlan(bn, tiles, -(-slabs // per), 8 * per)


def conv2d_dw(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """dW of the SAME stride-1 conv: x (B, H, W, Cin) and g (B, H, W,
    Cout) -> (kh, kw, Cin, Cout), always float32.

    Same contract as ``conv2d``.  No pixels (B*H*W = 0) give zeros of
    the full shape without a launch — a zero-row batch shard contributes
    a zero dW — and Cin or Cout of 0 an empty dW.  ``dw_plan`` picks the
    tile and the pixel chunks; their partial sums are reduced in a fixed
    order, no atomics, so a rerun gives the same bits."""
    if _on_cpu(x, g):
        return conv2d_dw_ref(x, g, kh, kw)
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(
            f"conv2d_dw: want x (B,H,W,Cin) and g (B,H,W,Cout), got "
            f"{tuple(x.shape)} and {tuple(g.shape)}"
        )
    _check("conv2d_dw", x, g, kh, kw)
    b, h, wd, cin = x.shape
    cout = g.shape[3]
    if kh * kw * cin * cout == 0 or b * h * wd == 0:
        return torch.zeros((kh, kw, cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((kh, kw, cin, cout), dtype=torch.float32, device=x.device)
    x = x.contiguous()
    g = g.contiguous()
    plan = dw_plan(x.shape, kh, kw, cout, x.element_size(), _sm_count(x.device))
    ws = (torch.empty((plan.splits, *dw.shape), dtype=torch.float32, device=x.device)
          if plan.splits > 1 else None)
    lib = conv2d_bwd_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.conv2d_dw_launch(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, h, wd, cin, cout, kh, kw, plan.bn, plan.splits, plan.chunk,
            _DTYPE_CODE[x.dtype], stream,
        )
    _raise_on(code, lib, "conv2d_bwd_error_string",
              f"conv2d_dw for x {tuple(x.shape)} g {tuple(g.shape)} {x.dtype}")
    _count(conv2d_dw)
    return dw


conv2d.launches = 0
conv2d_dx.launches = 0
conv2d_dw.launches = 0


@torch.library.custom_op("repro_torch::conv2d_dx", mutates_args=())
def conv2d_dx_op(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv2d_dx`` (K2 on the card) as a PyTorch operator."""
    return conv2d_dx(g, w)


@conv2d_dx_op.register_fake
def _(g, w):
    return g.new_empty((*g.shape[:3], w.shape[2]))


@torch.library.custom_op("repro_torch::conv2d_dw", mutates_args=())
def conv2d_dw_op(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """``conv2d_dw`` (K3 on the card) as a PyTorch operator."""
    return conv2d_dw(x, g, kh, kw)


@conv2d_dw_op.register_fake
def _(x, g, kh, kw):
    return x.new_empty((kh, kw, x.shape[3], g.shape[3]), dtype=torch.float32)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.conv2d_fwd)
    def _fwd(x_shape, w_shape, *args, out_shape=None, **kwargs):
        return conv_flops(x_shape, w_shape)

    @register_flop_formula(torch.ops.repro_torch.conv2d_dx)
    def _dx(g_shape, w_shape, *args, out_shape=None, **kwargs):
        return conv_flops(g_shape, w_shape)

    @register_flop_formula(torch.ops.repro_torch.conv2d_dw)
    def _dw(x_shape, g_shape, kh, kw, *args, out_shape=None, **kwargs):
        return conv_flops(x_shape, (kh, kw, x_shape[3], g_shape[3]))


_register_flops()


class Conv2dFunction(torch.autograd.Function):
    """The differentiable SAME stride-1 conv: forward ``conv2d`` (K1),
    backward ``conv2d_dx`` (K2) and ``conv2d_dw`` (K3), dW cast to w's
    dtype — the port's ``pconv``.  On CPU tensors every step runs the
    plain versions."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv2d_op(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = conv2d_dx_op(g, w) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = conv2d_dw_op(x, g, w.shape[0], w.shape[1]).to(w.dtype)
        return dx, dw
