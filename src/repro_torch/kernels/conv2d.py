"""SAME stride-1 conv2d forward on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/conv2d_fwd.cu``.

Counterpart of the Pallas TPU kernel ``repro/kernels/conv2d.py::
conv2d_pallas``.  A tensor on the CPU goes to the plain version
(``ref.conv2d_ref``); a CUDA tensor launches the kernel or raises —
there is no fallback.  ``conv2d.launches`` counts the kernel's
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels._build import conv2d_fwd_library
from repro_torch.kernels.ref import conv2d_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC SAME conv, stride 1, in x's dtype.

    x: (B, H, W, Cin) and w: (kh, kw, Cin, Cout), both float32 or both
    bfloat16, on one CUDA device; kh and kw odd.  Accumulates in fp32.
    An empty output (B, H or Cout of 0) is returned without a launch.
    Non-contiguous inputs (a weight shard sliced on its last axis) are
    made contiguous first."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_ref(x, w)
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(
            f"conv2d: x and w must lie on one CUDA device (or both on the "
            f"CPU), got {x.device} and {w.device}"
        )
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(
            f"conv2d: want x (B,H,W,Cin) and w (kh,kw,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    kh, kw, cin, cout = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv2d: odd kernels only, got {kh}x{kw}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"conv2d: x and w must both be float32 or both bfloat16, got "
            f"{x.dtype} and {w.dtype}"
        )
    b, h, wd, _ = x.shape
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    x = x.contiguous()
    w = w.contiguous()
    lib = conv2d_fwd_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.conv2d_fwd_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            b, h, wd, cin, cout, kh, kw, _DTYPE_CODE[x.dtype], stream,
        )
    if code != 0:
        raise RuntimeError(
            f"conv2d_fwd launch failed for x {tuple(x.shape)} w "
            f"{tuple(w.shape)} {x.dtype}: "
            f"{lib.conv2d_fwd_error_string(code).decode()} (cudaError {code})"
        )
    with _COUNT_LOCK:
        conv2d.launches += 1
    return y


conv2d.launches = 0
