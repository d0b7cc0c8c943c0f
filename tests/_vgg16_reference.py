"""Plain PyTorch reference of VGG-16, configuration D of Simonyan &
Zisserman (arXiv:1409.1556, Table 1), written from the paper and the
configuration (a dict of ``blocks``, the conv widths by block; ``dense``, the
fc units; ``dropout``, each fc's rate):

    for each block of ``blocks``: for each width, conv 3x3 (SAME,
    stride 1) + bias -> ReLU; then max-pool 2x2, stride 2
    -> flatten (H, W, C order)
    -> for each of ``dense`` (fc6, fc7, fc8): fc + bias; on all but the
       last, ReLU and then inverted dropout at its ``dropout`` rate
    -> softmax cross-entropy

trained by plain SGD.  Activations are NHWC, conv kernels HWIO, fc
kernels (in, out); params are named ``conv<block>_<i>`` and ``fc6``,
``fc7``, ``fc8``: the layouts and names the benchmark hands to the
program.

Departures from the paper, each the benchmark's configuration's:
plain SGD without the paper's momentum 0.9 and weight decay 5e-4 (the
system's step); He-normal conv weights (arXiv:1502.01852), fc weights
normal with std 0.01 (the paper's random init) and zero biases, where
the paper initialised deeper nets from configuration A; the
inputs as given, without the paper's mean-RGB subtraction, crops,
flips or scale jittering; any batch (the paper's 256 over 4 GPUs).
The dropout masks are drawn as the program draws them, so that the two
drop the same units: at step ``n`` (from 0), one CPU
``torch.Generator`` seeded ``(dropout_seed mod 2**43) * 2**20 + (n mod
2**20)`` draws, layer by layer, ``torch.rand((batch, units))``; a unit
is kept, and scaled by 1 / (1 - rate), where the draw is at least the
rate.

The reference runs in float64 (the program's float32 is held against
it).  ``tf32=True`` is the control: float32 with every conv and matmul
operand, and every gradient entering one, rounded to TF32 (10 mantissa
bits, to nearest even) and the products summed in float32 (TF32 off in
cuDNN and cuBLAS), which is what the card's TF32 path computes.

The tests' copy, which imports nothing of the port and nothing of the
benchmark; ``portbench/reference/vgg16.py`` is the benchmark's own.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for cuDNN convs and cuBLAS matmuls, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundIncomingGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _product(fn, a, b, tf32: bool):
    if not tf32:
        return fn(a, b)
    return _RoundIncomingGrad.apply(fn(_RoundOperand.apply(a), _RoundOperand.apply(b)))


def _conv_nhwc(x, w):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def conv(x, w, tf32=False):
    """SAME stride-1 conv, NHWC x HWIO -> NHWC."""
    return _product(_conv_nhwc, x, w, tf32)


def matmul(a, b, tf32=False):
    return _product(torch.matmul, a, b, tf32)


def pool2(x):
    """2x2 max-pool, stride 2, NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def conv_names(cfg) -> list:
    return [f"conv{b}_{i}" for b, block in enumerate(cfg["blocks"], 1)
            for i in range(1, len(block) + 1)]


def dense_names(cfg) -> list:
    return [f"fc{6 + j}" for j in range(len(cfg["dense"]))]


def mask_seed(dropout_seed: int, step: int) -> int:
    return (dropout_seed % 2 ** 43) * 2 ** 20 + step % 2 ** 20


def masks(cfg, dropout_seed: int, step: int, batch: int, dtype, device) -> list:
    """Step ``step``'s masks, (batch, units) per dense layer with
    dropout, else None."""
    g = torch.Generator().manual_seed(mask_seed(dropout_seed, step))
    out = []
    for units, rate in zip(cfg["dense"], cfg["dropout"]):
        if rate > 0:
            keep = torch.rand((batch, units), generator=g) >= rate
            out.append((keep.to(dtype) / (1.0 - rate)).to(device))
        else:
            out.append(None)
    return out


def logits(params, images, cfg, step_masks, tf32=False):
    x = images
    names = iter(conv_names(cfg))
    for block in cfg["blocks"]:
        for _ in block:
            p = params[next(names)]
            x = torch.relu(conv(x, p["kernel"], tf32) + p["bias"])
        x = pool2(x)
    h = x.reshape(x.shape[0], -1)
    last = len(cfg["dense"]) - 1
    for j, (name, m) in enumerate(zip(dense_names(cfg), step_masks)):
        h = matmul(h, params[name]["kernel"], tf32) + params[name]["bias"]
        if j < last:
            h = torch.relu(h)
            if m is not None:
                h = h * m
    return h


def sgd_steps(params0, batches, lr, cfg, device, dropout_seed, tf32=False,
              half_batch=False):
    """SGD steps from ``params0`` (numpy leaves, {layer: {name: array}})
    over ``batches`` (a list of {"images", "labels"} numpy dicts), the
    n-th with step n's masks, on ``device`` in float64 (``tf32``: the
    control).  ``half_batch`` (a fault) takes each step's mean over the
    first half of its rows only (and their masks).  Returns (losses, the
    params after the first step, the params after the last), the params
    as numpy leaves."""
    dtype = torch.float32 if tf32 else torch.float64
    leaves = [(l, n) for l in conv_names(cfg) + dense_names(cfg) for n in ("kernel", "bias")]
    with ieee_fp32():
        p = {l: {n: torch.from_numpy(np.asarray(params0[l][n])).to(device, dtype)
                 for n in params0[l]} for l in params0}
        losses, first = [], None
        for step, b in enumerate(batches):
            images = torch.from_numpy(b["images"]).to(device, dtype)
            labels = torch.from_numpy(b["labels"]).to(device).long()
            m = masks(cfg, dropout_seed, step, len(images), dtype, device)
            if half_batch:
                n = len(images) // 2
                images, labels = images[:n], labels[:n]
                m = [None if t is None else t[:n] for t in m]
            ts = [p[l][n].requires_grad_() for l, n in leaves]
            loss = F.cross_entropy(logits(p, images, cfg, m, tf32), labels)
            grads = torch.autograd.grad(loss, ts)
            with torch.no_grad():
                p = {l: {} for l in p}
                for (l, n), t, g in zip(leaves, ts, grads):
                    p[l][n] = (t - lr * g).detach()
            losses.append(float(loss.detach()))
            first = _host(p) if first is None else first
        last = _host(p)
    return losses, first, last


def _host(p) -> dict:
    return {l: {n: t.cpu().numpy() for n, t in d.items()} for l, d in p.items()}
