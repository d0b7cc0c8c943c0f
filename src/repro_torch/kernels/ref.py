"""Plain PyTorch versions of the port's kernels (the allclose references).

Each repeats its kernel's arithmetic with ordinary tensor operations and
runs on whatever device its inputs lie on.  The CPU tests use them, the
``torch`` conv backend runs them, and ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.  They are references, not
yardsticks of speed.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def ieee_fp32_matmul(device: torch.device):
    """Matmuls on the card in IEEE float32 for the duration, with the
    process-wide TF32 flag restored after.  The flag is global, so the
    callers that flip it take turns (two threads never interleave a save
    and a restore), and a caller may nest it."""
    if device.type != "cuda":
        yield
        return
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, SAME padding, stride 1, in x's dtype.

    Repeats the Pallas kernel's arithmetic (repro/kernels/conv2d.py,
    ``_conv2d_kernel``): explicit pad ``(k//2, k-1-k//2)`` on both
    spatial axes, then one matmul per tap (i, j), accumulated.  The
    accumulation runs in float32 (float64 inputs stay float64).  On the
    card TF32 is switched off for these matmuls and restored after, so
    float32 means IEEE float32 there too."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    if b * h * wd * cout == 0:
        return torch.zeros((b, h, wd, cout), dtype=x.dtype, device=x.device)
    acc_t = torch.promote_types(torch.promote_types(x.dtype, w.dtype), torch.float32)
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x.to(acc_t), (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    wa = w.to(acc_t)
    acc = torch.zeros((b * h * wd, cout), dtype=acc_t, device=x.device)
    with ieee_fp32_matmul(x.device):
        for i in range(kh):
            for j in range(kw):
                xs = xp[:, i : i + h, j : j + wd, :].reshape(b * h * wd, cin)
                acc = acc + xs @ wa[i, j]
    return acc.reshape(b, h, wd, cout).to(x.dtype)
