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


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """float32 accumulation, float64 for float64 inputs."""
    acc_t = torch.float32
    for t in ts:
        acc_t = torch.promote_types(acc_t, t.dtype)
    return acc_t


def _direct_conv(xp: torch.Tensor, w: torch.Tensor, h: int, wd: int) -> torch.Tensor:
    """The Pallas driver's arithmetic (repro/kernels/conv2d.py,
    ``_direct_conv`` / ``_conv2d_kernel``): a pre-padded input xp
    (B, h+kh-1, wd+kw-1, Cin) against w (kh, kw, Cin, Cout), one matmul
    per tap (i, j), accumulated.  Returns (B, h, wd, Cout) in the
    accumulation dtype."""
    kh, kw, cin, cout = w.shape
    b = xp.shape[0]
    acc_t = _acc_dtype(xp, w)
    xp, wa = xp.to(acc_t), w.to(acc_t)
    acc = torch.zeros((b * h * wd, cout), dtype=acc_t, device=xp.device)
    with ieee_fp32_matmul(xp.device):
        for i in range(kh):
            for j in range(kw):
                xs = xp[:, i : i + h, j : j + wd, :].reshape(b * h * wd, cin)
                acc = acc + xs @ wa[i, j]
    return acc.reshape(b, h, wd, cout)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, SAME padding, stride 1, in x's dtype.

    Repeats the Pallas kernel's arithmetic (repro/kernels/conv2d.py,
    ``conv2d_pallas``): explicit pad ``(k//2, k-1-k//2)`` on both
    spatial axes, then one matmul per tap (i, j), accumulated.  The
    accumulation runs in float32 (float64 inputs stay float64).  On the
    card TF32 is switched off for these matmuls and restored after, so
    float32 means IEEE float32 there too."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    if b * h * wd * cout == 0:
        return torch.zeros((b, h, wd, cout), dtype=x.dtype, device=x.device)
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    return _direct_conv(xp, w, h, wd).to(x.dtype)


def conv2d_dx_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX of the SAME stride-1 conv, in g's dtype: g (B, H, W, Cout)
    against the forward kernel w (kh, kw, Cin, Cout) -> (B, H, W, Cin).

    Repeats ``conv2d_dx_pallas``: the forward tap loop run on g against
    the spatially flipped, channel-swapped kernel, under the complementary
    pad ``(kh-1-kh//2, kh//2)`` (the forward's, for odd kernels)."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = g.shape
    if b * h * wd * cin == 0 or cout == 0:
        return torch.zeros((b, h, wd, cin), dtype=g.dtype, device=g.device)
    ph, pw = kh // 2, kw // 2
    wt = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)  # (kh, kw, Cout, Cin)
    gp = F.pad(g, (0, 0, kw - 1 - pw, pw, kh - 1 - ph, ph))
    return _direct_conv(gp, wt, h, wd).to(g.dtype)


def conv2d_dw_ref(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """dW of the SAME stride-1 conv: x (B, H, W, Cin) and g (B, H, W,
    Cout) -> (kh, kw, Cin, Cout) in float32 (float64 for float64 inputs).

    Repeats ``conv2d_dw_pallas``: per tap (i, j), one ``xs^T @ g``
    contracting the pixels of the shifted window of the SAME-padded x
    against g, accumulated in float32.  No pixels (B*H*W = 0) give a
    zero dW."""
    b, h, wd, cin = x.shape
    cout = g.shape[-1]
    acc_t = _acc_dtype(x, g)
    dw = torch.zeros((kh, kw, cin, cout), dtype=acc_t, device=x.device)
    if b * h * wd * cin * cout == 0:
        return dw
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x.to(acc_t), (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    gs = g.to(acc_t).reshape(b * h * wd, cout)
    with ieee_fp32_matmul(x.device):
        for i in range(kh):
            for j in range(kw):
                xs = xp[:, i : i + h, j : j + wd, :].reshape(b * h * wd, cin)
                dw[i, j] = xs.T @ gs
    return dw
