"""The paper's CIFAR-10 CNN (§5.2), in PyTorch:

    conv(5x5, C1) -> LRN -> maxpool/2 -> conv(5x5, C2) -> LRN ->
    maxpool/2 -> fully-connected -> softmax loss

Counterpart of ``repro/models/cnn.py``.  Params are a nested dict of
tensors — ``conv1``/``conv2``/``fc``, each with ``kernel`` and ``bias``
— in the JAX package's layouts (conv kernels HWIO, dense (in, out)), so
a JAX param tree carries across leaf by leaf (``convert.py``).  The
conv output-channel axis is the paper's distribution axis:
``make_cluster_train_step`` runs both conv layers, forward and backward,
over a ``HeteroCluster``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.core import spans
from repro_torch.core.backends import drain
from repro_torch.layers.conv import apply_conv, conv_axes, init_conv, max_pool
from repro_torch.layers.linear import apply_dense, dense_axes, init_dense
from repro_torch.layers.norm import local_response_norm
from repro_torch.sharding.partitioning import flatten_last

PAPER_SIZES = {
    "cifar_cnn_50_500": (50, 500),
    "cifar_cnn_150_800": (150, 800),
    "cifar_cnn_300_1000": (300, 1000),
    "cifar_cnn_500_1500": (500, 1500),
}


def make_cnn_config(c1: int, c2: int) -> CNNConfig:
    return CNNConfig(arch_id=f"cifar_cnn_{c1}_{c2}", c1_kernels=c1, c2_kernels=c2)


def init_cnn(generator: torch.Generator, cfg: CNNConfig, device="cpu"):
    """Random params from ``generator`` (a CPU generator, so the CPU and
    the card get the same numbers), placed on ``device``."""
    dtype = getattr(torch, cfg.dtype)
    k = cfg.kernel_size
    feat = cfg.image_size // (cfg.pool_stride ** 2)
    return {
        "conv1": init_conv(generator, k, k, cfg.image_channels, cfg.c1_kernels,
                           dtype, device),
        "conv2": init_conv(generator, k, k, cfg.c1_kernels, cfg.c2_kernels,
                           dtype, device),
        "fc": init_dense(generator, feat * feat * cfg.c2_kernels,
                         cfg.num_classes, dtype, use_bias=True, device=device),
    }


def cnn_axes():
    """Logical axes of ``init_cnn``'s params: each conv's kernel axis is
    the paper's (``conv_out``), the fc layer replicated."""
    return {
        "conv1": conv_axes(),
        "conv2": conv_axes(),
        "fc": dense_axes((None,), (None,), use_bias=True),
    }


def conv_fn_for_backend(backend: str = "torch"):
    """A ``conv_fn(params, x)`` for ``cnn_forward``, differentiable end
    to end: ``torch`` is the plain conv (``layers/conv.py::apply_conv``),
    ``cuda`` the hand-written kernels through ``Conv2dFunction`` — K1
    forward, K2 and K3 backward (on CPU tensors, their plain versions).
    The cluster's conv is ``core/cluster/cluster.py::
    make_distributed_conv``."""
    if backend == "torch":
        return apply_conv
    if backend == "cuda":
        from repro_torch.kernels.conv2d import Conv2dFunction

        def conv_fn(params, x):
            y = Conv2dFunction.apply(x, params["kernel"].to(x.dtype))
            return y + params["bias"].to(y.dtype)

        return conv_fn
    raise ValueError(f"unknown conv backend {backend!r}: 'torch' or 'cuda'")


def cnn_forward(params, images: torch.Tensor, *, cfg: CNNConfig,
                conv_fn=apply_conv) -> torch.Tensor:
    """images: (B, 32, 32, 3) NHWC -> logits (B, 10).  ``conv_fn``
    replaces only the convolution, as the paper does."""
    x = conv_fn(params["conv1"], images)
    x = torch.relu(x)
    x = local_response_norm(x)
    x = max_pool(x, cfg.pool_stride, cfg.pool_stride)
    x = conv_fn(params["conv2"], x)
    x = torch.relu(x)
    x = local_response_norm(x)
    x = max_pool(x, cfg.pool_stride, cfg.pool_stride)
    x = flatten_last(x, 3)
    return apply_dense(params["fc"], x)


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """In float32 (float64 stays float64), as the JAX loss takes it."""
    return torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)


def cnn_loss(params, images: torch.Tensor, labels: torch.Tensor, *,
             cfg: CNNConfig, conv_fn=apply_conv) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean softmax cross-entropy, accuracy) of a batch."""
    logits = cnn_forward(params, images, cfg=cfg, conv_fn=conv_fn)
    logp = _log_softmax(logits)
    loss = -logp.gather(1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)


def make_cluster_train_step(cluster, cfg: CNNConfig, *, lr: float = 0.05,
                            device="cuda"):
    """Full training steps of the paper's CNN over a HeteroCluster via the
    pipelined ``conv_train_step`` schedule: both conv layers run
    distributed — forward and backward — while the master-only stages
    (bias add, ReLU, LRN, pool, fc, softmax loss) overlap slave compute
    through the activation-stashing pipeline.

    The master-only stages run as plain PyTorch on ``device`` (the card
    by default) and keep the cluster's numpy-in/numpy-out contract of
    ``between``/``head``.  Their backward halves rematerialize the
    forward instead of holding autograd graphs across the pipeline.  The
    partition axis and the wire codec are the cluster's business: the
    step's numerics stay float32 on the master either way.

    Returns ``step(params, images, labels) -> (new_params, loss, acc)``
    applying plain SGD with ``lr`` to every parameter; params are
    tensors on ``device``, images and labels numpy arrays or tensors.

    While a torch profiler records, each call is the span ``step``
    (``core/spans.py``), and every move between the cluster's numpy and
    ``device`` a span with its bytes: ``step.to_card``/``step.to_host``
    for the activations and gradients of the stages and the head,
    ``step.kernels_to_host``/``step.kernels_to_card`` for the conv
    kernels around the cluster's step.
    """
    dev = torch.device(device)
    s = cfg.pool_stride

    def _tensor(a) -> torch.Tensor:
        a = np.ascontiguousarray(a, np.float32)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)

    def _moved(name, move, a):
        """``move(a)`` (``_tensor`` or ``_host``), the span ``name``
        with the bytes of ``a``."""
        if isinstance(a, torch.Tensor):
            drain(a)
        with spans.span(name, a.nbytes):
            return move(a)

    def _stage(y, b):
        """The master-only block after each conv: +bias, ReLU, LRN, pool."""
        z = torch.relu(y + b)
        z = local_response_norm(z)
        return max_pool(z, s, s)

    def _stage_fwd(y, b):
        with torch.no_grad():
            return _stage(y, b)

    def _stage_bwd(y, b, gz):
        with torch.enable_grad():
            y = y.detach().requires_grad_()
            b = b.detach().requires_grad_()
            return torch.autograd.grad(_stage(y, b), (y, b), gz)

    def _head_both(z, fc, labels, denom):
        """Loss contribution (sum/denom), correct-count, and the grads of
        the loss alone w.r.t. z and the fc params, of one microbatch."""
        with torch.enable_grad():
            z = z.detach().requires_grad_()
            fcp = {k: v.detach().requires_grad_() for k, v in fc.items()}
            logits = apply_dense(fcp, z.reshape(z.shape[0], -1))
            logp = _log_softmax(logits)
            loss = -logp.gather(1, labels[:, None]).sum() / denom
            gz, gk, gb = torch.autograd.grad(loss, (z, fcp["kernel"], fcp["bias"]))
        correct = (logits.argmax(-1) == labels).sum()
        return loss.detach(), correct, gz, {"kernel": gk, "bias": gb}

    warmed: set = set()  # microbatch sizes whose stages have run once

    def _warm(mb, params):
        """Run every master-only stage once for this microbatch size
        OUTSIDE the pipeline, synchronized on the card: one-time CUDA
        handle and allocator warm-up must not pollute the cluster's
        measured non-conv duty (it would strip the master's conv share)."""
        if mb in warmed:
            return
        warmed.add(mb)
        h1 = cfg.image_size
        h2, h3 = h1 // s, h1 // s ** 2
        for h, c, b in ((h1, cfg.c1_kernels, params["conv1"]["bias"]),
                        (h2, cfg.c2_kernels, params["conv2"]["bias"])):
            y = torch.zeros((mb, h, h, c), device=dev)
            gz = torch.zeros((mb, h // s, h // s, c), device=dev)
            _stage_fwd(y, b)
            _stage_bwd(y, b, gz)
        _head_both(torch.zeros((mb, h3, h3, cfg.c2_kernels), device=dev),
                   params["fc"], torch.zeros((mb,), dtype=torch.long, device=dev),
                   1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(params, images, labels):
        with spans.span("step"):
            return _step(params, images, labels)

    def _step(params, images, labels):
        if isinstance(images, torch.Tensor):
            drain(images)
            images = _host(images)
        else:
            images = np.asarray(images, np.float32)
        labels = torch.as_tensor(labels).long().to(dev)
        batch = images.shape[0]
        slices = cluster.microbatch_slices(batch)
        for sl in slices:
            _warm(sl.stop - sl.start, params)

        db = {0: None, 1: None}  # conv bias grads, summed over microbatches
        fc_grad = [None]         # fc param grads, ditto

        def make_between(k, bias):
            def f(y):
                y = _moved("step.to_card", _tensor, y)
                z = _stage_fwd(y, bias)

                def pull(gz):
                    gy, gb = _stage_bwd(y, bias, _moved("step.to_card", _tensor, gz))
                    db[k] = gb if db[k] is None else db[k] + gb
                    return _moved("step.to_host", _host, gy)

                return _moved("step.to_host", _host, z), pull
            return f

        def head(z, i):
            loss_i, correct_i, gz, gfc = _head_both(
                _moved("step.to_card", _tensor, z), params["fc"], labels[slices[i]],
                float(batch))
            fc_grad[0] = gfc if fc_grad[0] is None else {
                k: fc_grad[0][k] + gfc[k] for k in gfc}
            return (float(loss_i), float(correct_i)), _moved("step.to_host", _host, gz)

        between = [
            make_between(0, params["conv1"]["bias"]),
            make_between(1, params["conv2"]["bias"]),
        ]
        kernels = [_moved("step.kernels_to_host", _host, params[k]["kernel"])
                   for k in ("conv1", "conv2")]
        new_kernels, res = cluster.conv_train_step(
            images, kernels, between, head,
            update=lambda w, dw: w - lr * dw,
        )

        loss = float(sum(a[0] for a in res.head_aux))
        acc = float(sum(a[1] for a in res.head_aux)) / batch
        new_params = {
            "conv1": {
                "kernel": _moved("step.kernels_to_card", _tensor, new_kernels[0]),
                "bias": params["conv1"]["bias"] - lr * db[0],
            },
            "conv2": {
                "kernel": _moved("step.kernels_to_card", _tensor, new_kernels[1]),
                "bias": params["conv2"]["bias"] - lr * db[1],
            },
            "fc": {k: params["fc"][k] - lr * fc_grad[0][k] for k in params["fc"]},
        }
        return new_params, loss, acc

    return step
