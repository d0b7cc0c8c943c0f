"""Plain PyTorch reference of VGG-16, configuration D of Simonyan &
Zisserman (arXiv:1409.1556, Table 1), written from the paper and the
configuration file:

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
it).  ``tf32=True`` is the control, as in ``cifar_cnn.py``: float32 with
every conv and matmul operand, and every gradient entering one, rounded
to TF32 and the products summed in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.cifar_cnn import conv, ieee_fp32, matmul, pool2


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
