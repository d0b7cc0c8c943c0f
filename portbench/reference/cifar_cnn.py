"""Plain PyTorch reference of the paper's CIFAR-10 CNN (arXiv:1712.02546,
section 5.2), written from the paper and the configuration file:

    conv 5x5 (C1) + bias -> ReLU -> LRN -> max-pool 2
    -> conv 5x5 (C2) + bias -> ReLU -> LRN -> max-pool 2
    -> fc (flattened H, W, C order) + bias -> softmax cross-entropy

trained by plain SGD; and the serving chain of the port's cluster lane
(conv1 -> ReLU -> max-pool 2 -> conv2 -> ReLU -> max-pool 2 -> fc, no
bias, no LRN).  Activations are NHWC, conv kernels HWIO, the fc kernel
(in, out): the layouts the benchmark hands to the program.

The reference runs in float64 (the program's float32 is held against
it).  ``tf32=True`` is the control: float32 with every conv and matmul
operand, and every gradient entering one, rounded to TF32 (10 mantissa
bits, to nearest even) and the products summed in float32 (TF32 off in
cuDNN and cuBLAS), which is what the card's TF32 path computes.
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


def lrn(x, size: int, alpha: float, beta: float, k: float):
    """Cross-channel LRN: x / (k + alpha * sum of x^2 over the channels
    c - size//2 .. c + size//2, zero beyond the edges) ** beta."""
    c, half = x.shape[-1], size // 2
    sq = F.pad(x * x, (half, half))
    window = sum(sq[..., i:i + c] for i in range(size))
    return x / (k + alpha * window) ** beta


def pool2(x):
    """2x2 max-pool, stride 2, NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def train_logits(params, images, cfg, tf32=False, drop_channels=None):
    """Logits of the training network.  ``drop_channels`` (a fault, the
    exchange with the other devices left out) gives, per conv layer,
    output channels whose results never reach the master: zero there."""
    lr_ = cfg["lrn"]
    x = images
    for li, name in enumerate(("conv1", "conv2")):
        y = conv(x, params[name]["kernel"], tf32)
        if drop_channels is not None and len(drop_channels[li]):
            keep = torch.ones(y.shape[-1], device=y.device, dtype=y.dtype)
            keep[drop_channels[li]] = 0.0
            y = y * keep
        y = torch.relu(y + params[name]["bias"])
        x = pool2(lrn(y, lr_["size"], lr_["alpha"], lr_["beta"], lr_["k"]))
    flat = x.reshape(x.shape[0], -1)
    return matmul(flat, params["fc"]["kernel"], tf32) + params["fc"]["bias"]


def mean_loss(logits, labels):
    return F.cross_entropy(logits, labels.long())


LEAVES = (("conv1", "kernel"), ("conv1", "bias"), ("conv2", "kernel"),
          ("conv2", "bias"), ("fc", "kernel"), ("fc", "bias"))


def sgd_steps(params0, batches, lr, cfg, device, tf32=False, half_batch=False,
              drop_channels=None):
    """SGD steps from ``params0`` (numpy leaves, {layer: {name: array}})
    over ``batches`` (a list of {"images", "labels"} numpy dicts), on
    ``device`` in float64 (``tf32``: the control).  ``half_batch`` (a fault) takes each step's
    mean over the first half of its rows only.  Returns (losses, the
    params after the first step, the params after the last), the params
    as numpy leaves."""
    dtype = torch.float32 if tf32 else torch.float64
    with ieee_fp32():
        p = {l: {n: torch.from_numpy(np.asarray(params0[l][n])).to(device, dtype)
                 for n in params0[l]} for l in params0}
        losses, after = [], []
        for b in batches:
            images = torch.from_numpy(b["images"]).to(device, dtype)
            labels = torch.from_numpy(b["labels"]).to(device)
            if half_batch:
                images, labels = images[: len(images) // 2], labels[: len(labels) // 2]
            leaves = [p[l][n].requires_grad_() for l, n in LEAVES]
            loss = mean_loss(train_logits(p, images, cfg, tf32, drop_channels), labels)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = {l: {} for l in p}
                for (l, n), t, g in zip(LEAVES, leaves, grads):
                    p[l][n] = (t - lr * g).detach()
            losses.append(float(loss.detach()))
            after.append({l: {n: t.cpu().numpy() for n, t in d.items()} for l, d in p.items()})
    return losses, after[0], after[-1]


def serve_outputs(weights, fc, images, device, tf32=False, drop_channels=None,
                  rows=512):
    """The serving chain's outputs (n, classes) for ``images`` (n, H, W,
    C numpy), ``weights`` the two conv kernels and ``fc`` the head
    (numpy), computed on ``device`` in float64 (``tf32``: the control)
    in blocks of ``rows``.
    ``drop_channels`` as in ``train_logits`` (a fault)."""
    outs = []
    dtype = torch.float32 if tf32 else torch.float64
    with ieee_fp32(), torch.no_grad():
        ws = [torch.from_numpy(np.asarray(w)).to(device, dtype) for w in weights]
        fct = torch.from_numpy(np.asarray(fc)).to(device, dtype)
        for i in range(0, len(images), rows):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + rows])).to(device, dtype)
            for li, w in enumerate(ws):
                y = conv(x, w, tf32)
                if drop_channels is not None and len(drop_channels[li]):
                    y[..., drop_channels[li]] = 0.0
                x = pool2(torch.relu(y))
            outs.append(matmul(x.reshape(x.shape[0], -1), fct, tf32).cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0, fc.shape[-1]), np.float32)
