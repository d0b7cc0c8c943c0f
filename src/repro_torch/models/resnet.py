"""A residual network of bottleneck blocks (``configs/base.py::
ResNetConfig``, such as ResNet-50) trained over a ``HeteroCluster``.

``make_cluster_train_step`` (``models/cnn.py``) hands a ``ResNetConfig``
to ``make_resnet_train_step``.  The cluster's schedule
(``scheduler.conv_train_chain``) runs a chain: conv k's output goes
through the master-only stage k and becomes conv k+1's input.  The
network's convs are handed to it in execution order (``resnet_layers``:
``conv1``; then per block its projection ``res<s><b>_branch1`` where it
has one, ``_branch2a``, ``_branch2b``, ``_branch2c``), and the graph's
branches live in the stages, which keep per-microbatch state in FIFO
queues (the schedule runs every stage over the microbatches in order,
forward and backward):

* the stage after a conv whose output enters a block (the stem's and
  each ``2c``'s) hands the block's input on to the block's first conv,
  subsampled where that conv has stride 2, and queues it: as the
  shortcut of an identity block, or as ``2a``'s input for a block with
  a projection;
* the stage after a projection queues BN(projection) as the shortcut
  and hands ``2a`` the block's input, the projection's own input;
* the stage after ``2c`` takes BN, adds the queued shortcut and applies
  ReLU.

Backward, the block's input has two consumers, and the schedule reaches
the later one first: ``2a`` behind a projection (its dX arrives at the
projection's stage) or the identity shortcut (its gradient is the
``2c`` stage's).  That gradient is queued, and the producing stage adds
it to the dX it receives.  A projection's stage pulls the shortcut's
gradient, queued by the ``2c`` stage, back through its BN.

Strides run on the stride-1 kernels, exactly: conv1 7x7/2 (padding 3)
is the SAME stride-1 conv subsampled at even rows and columns in its
stage (output i covers input rows 2i-3 .. 2i+3, as ``F.conv2d(stride=2,
padding=3)``; the stage's VJP scatters the gradient back into zeros; 4x
conv1's work), and each 1x1/2 conv is a subsample of its input, in the
stage before it, followed by a stride-1 1x1 conv.

Batch norm takes train-mode statistics over each microbatch
(``layers/norm.py::batch_norm_fwd``) and its backward is
``batch_norm_bwd``; no running statistics are kept.  The head is the
global average pool, the dense layer and softmax cross-entropy.  Plain
SGD moves every parameter.  While a torch profiler records, each BN
forward and backward is the span ``step.norm`` (the bytes of its input;
label ``sweep``: ``fwd`` or ``bwd``), and each residual add, each sum of
a two-consumer tensor's gradients and each stride-2 subsample and its
transpose the span ``step.shortcut`` (the bytes of its output), each
ending on the card's drain; untraced, they add no synchronisation.
"""
from __future__ import annotations

import collections
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ResNetConfig
from repro_torch.core import spans
from repro_torch.core.backends import drain, seam
from repro_torch.layers.linear import apply_dense
from repro_torch.layers.norm import batch_norm_bwd, batch_norm_fwd
from repro_torch.models.cnn import (
    DENSE_INIT_STD,
    StepPlan,
    _log_softmax,
    card_place,
    cluster_train_step,
    handoff,
)


class Block(NamedTuple):
    """One bottleneck block: ``name`` as the released Caffe model names
    it (``2a`` .. ``5c``), its input and output widths, its stride, and
    whether its shortcut is a projection."""

    name: str
    cin: int
    width: int
    cout: int
    stride: int
    proj: bool


class Layer(NamedTuple):
    """One conv of the network, in the order the cluster runs them, and
    the stage after it.  ``role``: ``stem``, ``proj``, ``a``, ``b`` or
    ``c``; ``block``: the index of its block (None for the stem);
    ``feeds``: the block its stage's output enters (the stem's and every
    ``c`` but the last), else None; ``stride``: the conv's published
    stride (the cluster runs it at 1)."""

    name: str
    bn: str
    kernel_size: int
    cin: int
    cout: int
    role: str
    block: Optional[int]
    feeds: Optional[int]
    stride: int


def resnet_blocks(cfg: ResNetConfig) -> List[Block]:
    """The blocks, stage by stage: a projection where the width or the
    stride changes."""
    out, cin = [], cfg.stem_width
    for s, stage in enumerate(cfg.stages, 2):
        for j in range(stage.blocks):
            stride = stage.stride if j == 0 else 1
            cout = cfg.expansion * stage.width
            out.append(Block(f"{s}{chr(ord('a') + j)}", cin, stage.width, cout, stride,
                             stride != 1 or cin != cout))
            cin = cout
    return out


def resnet_layers(cfg: ResNetConfig) -> List[Layer]:
    """Every conv in execution order: ``conv1`` (BN ``bn_conv1``), then
    per block ``res<name>_branch1`` (its projection, where it has one),
    ``_branch2a``, ``_branch2b``, ``_branch2c`` (BN ``bn<name>_...``)."""
    blocks = resnet_blocks(cfg)
    k = cfg.stem_kernel
    layers = [Layer("conv1", "bn_conv1", k, cfg.image_channels, cfg.stem_width, "stem",
                    None, 0, 2)]
    for i, b in enumerate(blocks):
        feeds = i + 1 if i + 1 < len(blocks) else None

        def conv(branch, kernel_size, cin, cout, role, stride=1):
            layers.append(Layer(f"res{b.name}_{branch}", f"bn{b.name}_{branch}", kernel_size,
                                cin, cout, role, i, feeds if role == "c" else None, stride))

        if b.proj:
            conv("branch1", 1, b.cin, b.cout, "proj", b.stride)
        conv("branch2a", 1, b.cin, b.width, "a", b.stride)
        conv("branch2b", 3, b.width, b.width, "b")
        conv("branch2c", 1, b.width, b.cout, "c")
    return layers


def resnet_param_count(cfg: ResNetConfig) -> int:
    """Conv kernels, BN's gamma and beta, the dense kernel and bias."""
    n = sum(l.kernel_size ** 2 * l.cin * l.cout + 2 * l.cout for l in resnet_layers(cfg))
    width = cfg.expansion * cfg.stages[-1].width
    return n + width * cfg.num_classes + cfg.num_classes


def init_resnet(generator: torch.Generator, cfg: ResNetConfig, device="cpu"):
    """Params drawn from ``generator`` (a CPU generator) layer by layer
    in execution order and placed on ``device``: conv kernels (HWIO)
    He-normal (arXiv:1502.01852: standard normal times sqrt(2 /
    fan_in)); each BN ``gamma`` 1 and ``beta`` 0; the dense layer
    ``fc1000`` (in, out) normal with std ``models/cnn.py::
    DENSE_INIT_STD``, zero bias."""
    dtype = getattr(torch, cfg.dtype)
    params = {}
    for l in resnet_layers(cfg):
        k = l.kernel_size
        w = torch.randn((k, k, l.cin, l.cout), generator=generator)
        params[l.name] = {"kernel": (w * math.sqrt(2.0 / (k * k * l.cin))).to(device, dtype)}
        params[l.bn] = {"gamma": torch.ones((l.cout,), dtype=dtype, device=device),
                        "beta": torch.zeros((l.cout,), dtype=dtype, device=device)}
    width = cfg.expansion * cfg.stages[-1].width
    w = torch.randn((width, cfg.num_classes), generator=generator) * DENSE_INIT_STD
    params["fc1000"] = {"kernel": w.to(device, dtype),
                        "bias": torch.zeros((cfg.num_classes,), dtype=dtype, device=device)}
    return params


def subsample(t: torch.Tensor) -> torch.Tensor:
    """Even rows and columns of NHWC ``t``: a stride-2 sampling."""
    return t[:, ::2, ::2].contiguous()


def subsample_vjp(g: torch.Tensor, shape) -> torch.Tensor:
    """The transpose of ``subsample`` into ``shape``: ``g`` at even rows
    and columns, zeros elsewhere."""
    out = g.new_zeros(shape)
    out[:, ::2, ::2] = g
    return out


def stem_pool(t: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3/2 max-pool with padding 1 over NHWC ``t``."""
    return F.max_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _timed(name: str, nbytes: int, fn, *args, **labels):
    """``fn(*args)``; while a profiler records, the span ``name`` up to
    the card's drain."""
    if not spans.recording():
        return fn(*args)
    with spans.span(name, nbytes, **labels):
        out = fn(*args)
        drain(out[0] if isinstance(out, tuple) else out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sub_nbytes(t: torch.Tensor) -> int:
    """The bytes of ``subsample(t)``."""
    n, h, w, c = t.shape
    return n * -(-h // 2) * -(-w // 2) * c * t.element_size()


class Saved(NamedTuple):
    """What a stage keeps for its VJP: BN's input and statistics, the
    ReLU's output, the shape of the stage's output before a subsample
    for the next conv, and the stem's conv output's shape."""

    y: torch.Tensor
    mean: torch.Tensor
    rstd: torch.Tensor
    r: Optional[torch.Tensor] = None
    full: Optional[Tuple[int, ...]] = None
    conv_shape: Optional[Tuple[int, ...]] = None


def stage_fwd(layer: Layer, sub_out: bool, y, bn, eps: float, shortcut=None):
    """The stage after ``layer``'s conv output ``y``: ``(out, Saved)``.
    The stem subsamples ``y`` (its stride 2), takes BN, ReLU and the
    3x3/2 pool; a projection's stage returns BN(y), the shortcut; ``c``
    adds ``shortcut`` after BN, then ReLU; ``a`` and ``b`` BN and ReLU.
    ``sub_out``: the output enters a stride-2 conv, and is subsampled."""
    conv_shape = tuple(y.shape)
    if layer.role == "stem":
        y = _timed("step.shortcut", _sub_nbytes(y), subsample, y)
    n, mean, rstd = _timed("step.norm", _nbytes(y), batch_norm_fwd, y, bn["gamma"],
                           bn["beta"], eps, sweep="fwd")
    if layer.role == "proj":
        return n, Saved(y, mean, rstd)
    if layer.role == "c":
        n = _timed("step.shortcut", _nbytes(n), torch.add, n, shortcut)
    r = torch.relu_(n)
    out = stem_pool(r) if layer.role == "stem" else r
    full = tuple(out.shape)
    if sub_out:
        out = _timed("step.shortcut", _sub_nbytes(out), subsample, out)
    return out, Saved(y, mean, rstd, r, full, conv_shape)


def stage_vjp(layer: Layer, sub_out: bool, saved: Saved, g, bn):
    """``stage_fwd``'s VJP for the gradient ``g`` of its output (of a
    projection's stage: the shortcut's gradient): ``(gy, dgamma, dbeta,
    g_shortcut)``, ``g_shortcut`` the ``c`` stage's shortcut gradient,
    else None."""
    y, mean, rstd, r, full, conv_shape = saved
    g_sc = None
    if layer.role != "proj":
        if sub_out:
            g = _timed("step.shortcut", g.element_size() * math.prod(full), subsample_vjp,
                       g, full)
        if layer.role == "stem":
            with torch.enable_grad():
                rr = r.detach().requires_grad_()
                (g,) = torch.autograd.grad(stem_pool(rr), rr, g)
        g = torch.where(r > 0, g, 0.0)
        g_sc = g if layer.role == "c" else None
    gy, dgamma, dbeta = _timed("step.norm", _nbytes(y), batch_norm_bwd, y, mean, rstd,
                               bn["gamma"], g, sweep="bwd")
    if layer.role == "stem":
        gy = _timed("step.shortcut", gy.element_size() * math.prod(conv_shape),
                    subsample_vjp, gy, conv_shape)
    return gy, dgamma, dbeta, g_sc


def make_resnet_train_step(cluster, cfg: ResNetConfig, *, lr: float = 0.05,
                           device="cuda"):
    """Full training steps of ``cfg`` over ``cluster``'s
    ``conv_train_step``, through ``models/cnn.py::cluster_train_step``
    as a chain's: every conv (``resnet_layers``, projections included)
    forward and backward over the cluster's devices; BN, ReLU, the
    residual adds, the subsamples, the pools and the head in master-only
    stages on ``device``; plain SGD with ``lr`` on every parameter.  The
    card path and the host path are the chain's: the stages take and
    return tensors on ``device`` where the cluster's master computes
    there, else numpy.

    Returns ``step(params, images, labels) -> (new_params, loss, acc)``;
    params as ``init_resnet`` draws them, tensors on ``device``; images
    (B, H, W, C) and labels numpy arrays or tensors.  The spans are the
    chain's (``step``, ``step.head``, the seam's) and ``step.norm`` and
    ``step.shortcut`` (the module's docstring)."""
    layers = resnet_layers(cfg)
    blocks = resnet_blocks(cfg)
    eps = cfg.bn_eps
    dev = torch.device(device)
    place = card_place(cluster, dev)
    # the stage's output enters a stride-2 block: subsampled there
    sub_out = [l.feeds is not None and blocks[l.feeds].stride == 2 for l in layers]

    def _head(z, fc, labels, denom):
        """One microbatch's loss contribution (sum / denom), its correct
        count, and the loss's grads w.r.t. z and the dense layer."""
        with torch.enable_grad():
            z = z.detach().requires_grad_()
            p = {k: v.detach().requires_grad_() for k, v in fc.items()}
            logits = apply_dense(p, z.mean((1, 2)))
            loss = -_log_softmax(logits).gather(1, labels[:, None]).sum() / denom
            gz, gk, gb = torch.autograd.grad(loss, (z, p["kernel"], p["bias"]))
        correct = (logits.argmax(-1) == labels).sum()
        return loss.detach(), correct, gz, {"fc1000": {"kernel": gk, "bias": gb}}

    def _warm(mb, params, size):
        """Every stage and its VJP once for this microbatch size, at each
        distinct shape, and the head, outside the pipeline: one-time
        launch and allocator costs must not count in the cluster's
        measured non-conv duty."""
        h, done = size, set()
        for l, sub in zip(layers, sub_out):
            key = (l.role, h, l.cout, sub)
            if key not in done:
                done.add(key)
                bn = params[l.bn]
                y = torch.zeros((mb, h, h, l.cout), device=dev)
                shortcut = torch.zeros_like(y) if l.role == "c" else None
                out, saved = stage_fwd(l, sub, y, bn, eps, shortcut)
                stage_vjp(l, sub, saved, torch.zeros_like(out), bn)
            if l.role == "stem":
                h = ((h + 1) // 2 + 1) // 2
            elif l.role == "c" and sub:
                h = (h + 1) // 2
        _head(torch.zeros((mb, h, h, layers[-1].cout), device=dev), params["fc1000"],
              torch.zeros((mb,), dtype=torch.long, device=dev), 1.0)

    def _begin(params, batch):
        # per block, FIFO over the microbatches: "input" (2a's input
        # behind a projection), "shortcut", "g_shortcut" (to the
        # projection's stage), "g_input" (the later consumer's gradient
        # of the block's input, to its producer)
        queues = collections.defaultdict(collections.deque)
        bn_grads = {}

        def add_bn(name, dgamma, dbeta):
            if name in bn_grads:
                g0, b0 = bn_grads[name]
                dgamma, dbeta = g0 + dgamma, b0 + dbeta
            bn_grads[name] = (dgamma, dbeta)

        def make_between(k):
            layer, sub = layers[k], sub_out[k]
            bn = params[layer.bn]

            def f(y):
                y = seam(dev, "step.to_card", y=y)
                shortcut = (queues[layer.block, "shortcut"].popleft()
                            if layer.role == "c" else None)
                out, saved = stage_fwd(layer, sub, y, bn, eps, shortcut)
                if layer.role == "proj":
                    queues[layer.block, "shortcut"].append(out)
                    out = queues[layer.block, "input"].popleft()
                if layer.feeds is not None:
                    kind = "input" if blocks[layer.feeds].proj else "shortcut"
                    queues[layer.feeds, kind].append(out)

                def pull(g):
                    g = seam(dev, "step.to_card", gz=g)
                    if layer.feeds is not None:
                        g = _timed("step.shortcut", _nbytes(g), torch.add, g,
                                   queues[layer.feeds, "g_input"].popleft())
                    if layer.role == "proj":
                        queues[layer.block, "g_input"].append(g)
                        g = queues[layer.block, "g_shortcut"].popleft()
                    gy, dgamma, dbeta, g_sc = stage_vjp(layer, sub, saved, g, bn)
                    add_bn(layer.bn, dgamma, dbeta)
                    if g_sc is not None:
                        kind = "g_shortcut" if blocks[layer.block].proj else "g_input"
                        queues[layer.block, kind].append(g_sc)
                    return handoff(place, "step.to_host", gy=gy)

                return handoff(place, "step.to_host", z=out), pull
            return f

        def head(z, labels, _sl, denom):
            return _head(z, params["fc1000"], labels, denom)

        def finish(kernels, head_grad):
            left = [key for key, q in queues.items() if q]
            assert not left, f"stage state left over a step: {left}"
            new_params = {}
            for k, l in enumerate(layers):
                new_params[l.name] = {"kernel": kernels[k]}
                dgamma, dbeta = bn_grads[l.bn]
                new_params[l.bn] = {"gamma": params[l.bn]["gamma"] - lr * dgamma,
                                    "beta": params[l.bn]["beta"] - lr * dbeta}
            new_params["fc1000"] = {k: params["fc1000"][k] - lr * head_grad["fc1000"][k]
                                    for k in params["fc1000"]}
            return new_params

        return StepPlan([make_between(k) for k in range(len(layers))], head, finish)

    return cluster_train_step(cluster, dev, lr=lr, kernel_names=[l.name for l in layers],
                              head_layers=1, warm=_warm, begin=_begin)
