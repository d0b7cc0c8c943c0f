"""Plain PyTorch reference of ResNet-50 (He et al., arXiv:1512.03385,
Table 1, the 50-layer column), written from the paper and the
configuration (a dict: ``stem_width``, ``stem_kernel``; ``stages``, each
``{"width", "blocks", "stride"}``; ``expansion``, ``num_classes``,
``bn_eps``):

    conv1 (``stem_kernel`` square, stride 2, padding ``stem_kernel //
    2``) -> BN -> ReLU -> max-pool 3x3, stride 2, padding 1
    -> per stage, ``blocks`` bottleneck blocks: 1x1 (``width``, the
       block's stride) -> BN -> ReLU -> 3x3 (``width``, padding 1) -> BN
       -> ReLU -> 1x1 (``expansion`` x ``width``) -> BN; plus the
       shortcut: the block's input, or where the width or the stride
       changes a projection (1x1 conv at the block's stride -> BN,
       option B); -> ReLU.  The stride is the stage's on its first
       block, 1 on the others.
    -> mean over H and W -> fc (+ bias) -> softmax cross-entropy

trained by plain SGD.  The convs have no bias.  Batch norm is
``F.batch_norm`` in training mode (biased variance) over each
consecutive group of ``bn_group`` rows of the batch: the statistics of
a worker's microbatch.  Activations are NHWC, conv kernels HWIO, the fc
kernel (in, out); params are named as in the authors' released Caffe
model: ``conv1`` / ``bn_conv1``, ``res<stage><block>_branch1`` (the
projection), ``_branch2a``, ``_branch2b``, ``_branch2c`` (``kernel``),
each with ``bn<stage><block>_<branch>`` (``gamma``, ``beta``), and
``fc1000`` (``kernel``, ``bias``).  Where a block has stride 2, both its
first 1x1 and its projection take it, as in that model.

Departures from the paper, each the benchmark's configuration's: plain
SGD without momentum 0.9 and weight decay 1e-4; no running statistics
(nothing is evaluated); the inputs as given, without the paper's
augmentation.

The reference runs in float64 (the program's float32 is held against
it).  A step runs group by group, each group's loss (its rows' summed
cross-entropy over the batch) differentiated alone and the gradients
summed: the groups' statistics are independent, so the sum is the
batch's gradient, and a group is the most the card holds at a time.
``tf32=True`` is the control: float32 with every conv and matmul
operand, and every gradient entering one, rounded to TF32 (10 mantissa
bits, to nearest even) and the products summed in float32 (TF32 off in
cuDNN and cuBLAS), which is what the card's TF32 path computes.
``fp32=True`` is a witness: the same steps in plain IEEE float32 (TF32
off), the precision the program states, without its kernels.
``half_batch`` (a fault) takes each step's mean over the first half of
its rows; ``drop_shortcut`` (a fault) passes no gradient through the
shortcuts.
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


def conv(x, w, stride: int, tf32=False):
    """NHWC x HWIO -> NHWC, padding half the kernel, at ``stride``."""
    def f(a, b):
        y = F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1), stride=stride,
                     padding=b.shape[0] // 2)
        return y.permute(0, 2, 3, 1)
    return _product(f, x, w, tf32)


def bn(x, p, eps):
    y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, p["gamma"], p["beta"],
                     training=True, eps=eps)
    return y.permute(0, 2, 3, 1)


def blocks(cfg) -> list:
    """(name, stride, projection) of each block, stage by stage."""
    out, cin = [], cfg["stem_width"]
    for s, stage in enumerate(cfg["stages"], 2):
        cout = cfg["expansion"] * stage["width"]
        for j in range(stage["blocks"]):
            stride = stage["stride"] if j == 0 else 1
            out.append((f"{s}{chr(ord('a') + j)}", stride, stride != 1 or cin != cout))
            cin = cout
    return out


def leaf_names(cfg) -> list:
    """(layer, name) of every param."""
    out = [("conv1", "kernel"), ("bn_conv1", "gamma"), ("bn_conv1", "beta")]
    for name, _, proj in blocks(cfg):
        for br in (["branch1"] if proj else []) + ["branch2a", "branch2b", "branch2c"]:
            out += [(f"res{name}_{br}", "kernel"), (f"bn{name}_{br}", "gamma"),
                    (f"bn{name}_{br}", "beta")]
    return out + [("fc1000", "kernel"), ("fc1000", "bias")]


def logits(params, images, cfg, tf32=False, drop_shortcut=False):
    eps = cfg["bn_eps"]
    x = conv(images, params["conv1"]["kernel"], 2, tf32)
    x = torch.relu(bn(x, params["bn_conv1"], eps))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    for name, stride, proj in blocks(cfg):
        def unit(h, branch, s=1):
            return bn(conv(h, params[f"res{name}_{branch}"]["kernel"], s, tf32),
                      params[f"bn{name}_{branch}"], eps)
        shortcut = unit(x, "branch1", stride) if proj else x
        h = torch.relu(unit(x, "branch2a", stride))
        h = torch.relu(unit(h, "branch2b"))
        h = unit(h, "branch2c")
        x = torch.relu(h + (shortcut.detach() if drop_shortcut else shortcut))
    pooled = x.mean((1, 2))
    return _product(torch.matmul, pooled, params["fc1000"]["kernel"], tf32) + \
        params["fc1000"]["bias"]


def sgd_steps(params0, batches, lr, cfg, device, bn_group, tf32=False, half_batch=False,
              drop_shortcut=False, fp32=False):
    """SGD steps from ``params0`` (numpy leaves, {layer: {name: array}})
    over ``batches`` (a list of {"images", "labels"} numpy dicts) on
    ``device`` in float64 (``tf32``: the control; ``fp32``: the
    witness, in float32), batch norm over each
    group of ``bn_group`` rows.  Returns (losses, the params after the
    first step, the params after the last), the params as numpy leaves."""
    dtype = torch.float32 if tf32 or fp32 else torch.float64
    leaves = leaf_names(cfg)
    with ieee_fp32():
        p = {l: {n: torch.from_numpy(np.asarray(params0[l][n])).to(device, dtype)
                 for n in params0[l]} for l in params0}
        losses, first = [], None
        for b in batches:
            images = torch.from_numpy(b["images"]).to(device, dtype)
            labels = torch.from_numpy(b["labels"]).to(device).long()
            if half_batch:
                n = len(images) // 2
                images, labels = images[:n], labels[:n]
            ts = [p[l][n].requires_grad_() for l, n in leaves]
            total, grads = 0.0, None
            for g0 in range(0, len(images), bn_group):
                rows = slice(g0, g0 + bn_group)
                out = logits(p, images[rows], cfg, tf32, drop_shortcut)
                loss = F.cross_entropy(out, labels[rows], reduction="sum") / len(images)
                # a dropped shortcut leaves the projections unused
                gs = [torch.zeros_like(t) if g is None else g for t, g in
                      zip(ts, torch.autograd.grad(loss, ts, allow_unused=True))]
                grads = gs if grads is None else [a + c for a, c in zip(grads, gs)]
                total += float(loss.detach())
            with torch.no_grad():
                p = {l: {} for l in p}
                for (l, n), t, g in zip(leaves, ts, grads):
                    p[l][n] = (t - lr * g).detach()
            losses.append(total)
            first = _host(p) if first is None else first
        last = _host(p)
    return losses, first, last


def _host(p) -> dict:
    return {l: {n: t.cpu().numpy() for n, t in d.items()} for l, d in p.items()}
