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

``make_cluster_train_step`` trains any ``ConvChainConfig`` (``conv_chain``) too,
such as VGG-16 (``configs/vgg16.py``): a chain of conv layers, each with
its own stage, and a dense head with ReLU and dropout; ``init_chain``
draws its params, ``dropout_masks`` its masks.  A ``ResNetConfig``
(ResNet-50, ``configs/resnet50.py``) goes to ``models/resnet.py``; both
build their step on ``cluster_train_step``.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import (
    ChainConv,
    ChainDense,
    CNNConfig,
    ConvChainConfig,
    ResNetConfig,
)
from repro_torch.core import spans
from repro_torch.core.backends import drain, seam
from repro_torch.layers.conv import apply_conv, conv_axes, init_conv, max_pool
from repro_torch.layers.linear import apply_dense, dense_axes, init_dense
from repro_torch.layers.norm import local_response_norm
from repro_torch.sharding.partitioning import flatten_last

# the dense head's init: VGG's random init (arXiv:1409.1556, 3.1), as
# torchvision's VGG draws its fc layers.  He-normal there (ReLU's gain
# over thousands of positive features) starts VGG-16 at a loss of 16-30
# where chance is 6.9.
DENSE_INIT_STD = 0.01

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


def conv_chain(cfg) -> ConvChainConfig:
    """``cfg`` as a chain of conv layers and a dense head: a
    ``ConvChainConfig`` as it is; the paper's ``CNNConfig`` as ``conv1``
    and ``conv2`` (each +bias, ReLU, LRN, pool) and one dense layer
    ``fc``, the names and layouts of ``init_cnn``'s params."""
    if isinstance(cfg, ConvChainConfig):
        return cfg
    k = cfg.kernel_size
    return ConvChainConfig(
        arch_id=cfg.arch_id,
        convs=(ChainConv("conv1", cfg.c1_kernels, k, lrn=True, pool=True),
               ChainConv("conv2", cfg.c2_kernels, k, lrn=True, pool=True)),
        dense=(ChainDense("fc", cfg.num_classes),),
        image_size=cfg.image_size, image_channels=cfg.image_channels,
        pool_stride=cfg.pool_stride, dtype=cfg.dtype,
    )


def init_chain(generator: torch.Generator, cfg: ConvChainConfig, device="cpu"):
    """Params drawn from ``generator`` (a CPU generator) layer by layer
    in the chain's order and placed on ``device``: conv kernels
    He-normal (arXiv:1502.01852: standard normal times sqrt(2 /
    fan_in)), dense kernels normal with std ``DENSE_INIT_STD``, zero
    biases.  ``{name: {"kernel", "bias"}}``, conv kernels HWIO, dense
    (in, out)."""
    dtype = getattr(torch, cfg.dtype)
    params = {}

    def layer(name, shape, std):
        w = torch.randn(shape, generator=generator) * std
        params[name] = {"kernel": w.to(device, dtype),
                        "bias": torch.zeros((shape[-1],), dtype=dtype, device=device)}

    cin, h = cfg.image_channels, cfg.image_size
    for c in cfg.convs:
        k = c.kernel_size
        layer(c.name, (k, k, cin, c.kernels), math.sqrt(2.0 / (k * k * cin)))
        cin, h = c.kernels, h // cfg.pool_stride if c.pool else h
    n_in = h * h * cin
    for d in cfg.dense:
        layer(d.name, (n_in, d.units), DENSE_INIT_STD)
        n_in = d.units
    return params


def mask_seed(dropout_seed: int, step: int) -> int:
    """The seed of step ``step``'s dropout masks: ``dropout_seed`` (mod
    2**43) times 2**20 plus ``step`` (mod 2**20)."""
    return (dropout_seed % 2 ** 43) * 2 ** 20 + step % 2 ** 20


def dropout_masks(cfg: ConvChainConfig, dropout_seed: int, step: int, batch: int):
    """The whole batch's inverted-dropout masks of step ``step``, one per
    dense layer of ``cfg`` (None where its rate is 0): ``(batch, units)``
    float32 on the CPU, 1 / (1 - rate) where ``torch.rand`` reads at
    least the rate, else 0, drawn layer by layer from one CPU generator
    seeded ``mask_seed(dropout_seed, step)``.  A microbatch takes its
    rows, so the masks do not depend on the microbatch split."""
    g = torch.Generator().manual_seed(mask_seed(dropout_seed, step))
    masks = []
    for d in cfg.dense:
        if d.dropout > 0:
            keep = torch.rand((batch, d.units), generator=g) >= d.dropout
            masks.append(keep.to(torch.float32) / (1.0 - d.dropout))
        else:
            masks.append(None)
    return masks


class StepPlan(NamedTuple):
    """One step's model side, as ``cluster_train_step`` runs it:
    ``between``, the stage after each conv (``conv_train_step``'s);
    ``head(z, labels, sl, denom) -> (loss, correct, gz, grads)``, one
    microbatch's head on ``device`` (``sl`` its rows of the batch,
    ``grads`` ``{name: {leaf: grad}}`` of the head's params, summed over
    the microbatches); ``finish(kernels, head_grads) -> new_params``,
    SGD on every param but the conv kernels, whose new values (on
    ``device``) it is handed."""

    between: List[Callable]
    head: Callable
    finish: Callable


def card_place(cluster, dev: torch.device):
    """Where the cluster's operands lie: ``dev`` where the cluster's
    master computes there (the card path), else None (numpy)."""
    master = cluster.master_device
    card = master is not None and master.type == dev.type and (
        (master.index or 0) == (dev.index or 0))
    return dev if card else None


def handoff(place, name, **t):
    """A stage's or the head's result handed to the cluster, after the
    card's drain: as it is on the card path, else numpy (the span
    ``name``)."""
    for v in t.values():
        drain(v)
    return seam(place, name, **t)


def cluster_train_step(cluster, dev: torch.device, *, lr: float, kernel_names,
                       head_layers: int, warm, begin):
    """The step that ``make_cluster_train_step`` builds for every
    configuration, around its model side: the images and labels to
    ``dev`` (the cluster's place for the images), ``warm(mb, params,
    image_size)`` once per microbatch size and drained on the card,
    ``begin(params, batch) -> StepPlan``, the conv kernels
    ``kernel_names`` through ``cluster.conv_train_step`` with plain SGD,
    each microbatch's head under the span ``step.head`` (labels ``rows``
    and ``layers``: ``head_layers``), and the new kernels back on
    ``dev``."""
    place = card_place(cluster, dev)
    warmed: set = set()  # microbatch sizes whose stages have run once

    def step(params, images, labels):
        with spans.span("step"):
            return _step(params, images, labels)

    def _step(params, images, labels):
        images = seam(place, "step.to_host" if place is None else "step.to_card",
                      images=images)
        labels = torch.as_tensor(labels).long().to(dev)
        batch = images.shape[0]
        slices = cluster.microbatch_slices(batch)
        for sl in slices:
            mb = sl.stop - sl.start
            if mb not in warmed:
                warmed.add(mb)
                warm(mb, params, images.shape[1])
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        plan = begin(params, batch)
        head_grad = [None]  # the head's param grads, summed over microbatches

        def head(z, i):
            sl = slices[i]
            zt = seam(dev, "step.to_card", z=z)
            with spans.span("step.head", z.nbytes, rows=sl.stop - sl.start,
                            layers=head_layers):
                loss_i, correct_i, gz, g = plan.head(zt, labels[sl], sl, float(batch))
                drain(gz)
            head_grad[0] = g if head_grad[0] is None else {
                n: {k: head_grad[0][n][k] + v for k, v in d.items()} for n, d in g.items()}
            return (float(loss_i), float(correct_i)), seam(place, "step.to_host", gz=gz)

        kernels = [seam(place, "step.kernels_to_host", w=params[n]["kernel"])
                   for n in kernel_names]
        new_kernels, res = cluster.conv_train_step(
            images, kernels, plan.between, head,
            update=lambda w, dw: w - lr * dw,
        )
        loss = float(sum(a[0] for a in res.head_aux))
        acc = float(sum(a[1] for a in res.head_aux)) / batch
        new_kernels = [seam(dev, "step.kernels_to_card", w=w) for w in new_kernels]
        return plan.finish(new_kernels, head_grad[0]), loss, acc

    return step


def make_cluster_train_step(cluster, cfg, *, lr: float = 0.05, device="cuda",
                            dropout_seed: int = 0):
    """Full training steps of a CNN over a HeteroCluster via the
    pipelined ``conv_train_step`` schedule: every conv layer runs
    distributed — forward and backward — while the master-only stages
    (each conv's +bias, ReLU, LRN and pool, as its layer has them; the
    dense head with its ReLUs and dropout; softmax cross-entropy)
    overlap slave compute through the activation-stashing pipeline.
    ``cfg`` is the paper's ``CNNConfig`` (two convs, one fc) or any
    ``ConvChainConfig`` (``conv_chain``); a ``ResNetConfig`` trains
    through ``models/resnet.py::make_resnet_train_step`` (``dropout_seed``
    unused: it has no dropout).

    The master-only stages run as plain PyTorch on ``device`` (the card
    by default).  Where the cluster's master computes on ``device``
    (``cluster.master_device``), the step hands the cluster the params'
    kernels and the images on ``device``, and the stages, the head and
    SGD on the kernels take and return tensors there: only the slaves'
    slices leave it (the card path).  Any other master gets numpy: the
    kernels and every activation and gradient between the cluster and
    the stages cross to the host and back, and SGD on the kernels runs
    in numpy.  The backward halves of the stages rematerialize the
    forward instead of holding autograd graphs across the pipeline.  The
    partition axis and the wire codec are the cluster's business: the
    step's numerics stay float32 on the master either way.

    Dropout is inverted: the n-th call (from 0) draws the whole batch's
    masks at its start with ``dropout_masks(cfg, dropout_seed, n,
    batch)``, and each microbatch takes its rows.

    Returns ``step(params, images, labels) -> (new_params, loss, acc)``
    applying plain SGD with ``lr`` to every parameter; params are
    tensors on ``device``, images and labels numpy arrays or tensors.

    While a torch profiler records, each call is the span ``step``
    (``core/spans.py``), and every move between the host's numpy and
    ``device`` a span with its bytes (``backends.seam``):
    ``step.to_card``/``step.to_host`` for the images and for the
    activations and gradients of the stages and the head,
    ``step.kernels_to_host``/``step.kernels_to_card`` for the conv
    kernels around the cluster's step (the host path's);
    ``step.update_host`` is SGD on the conv kernels; ``step.head`` is
    each microbatch's head (the bytes of its input ``z``; labels
    ``rows`` and ``layers``, the dense layers), up to the card's drain,
    and ``step.masks`` the dropout masks' draw and copy (their bytes).
    Each stage and the head end on the card's drain, so the cluster's
    ``LayerTiming.comp_s`` holds their device time.
    """
    if isinstance(cfg, ResNetConfig):
        from repro_torch.models.resnet import make_resnet_train_step

        return make_resnet_train_step(cluster, cfg, lr=lr, device=device)
    chain = conv_chain(cfg)
    convs, dense = chain.convs, chain.dense
    dev = torch.device(device)
    place = card_place(cluster, dev)
    s = chain.pool_stride
    calls = [0]  # steps begun, the index of the next step's masks

    def _stage(y, b, layer):
        """The master-only block after a conv: +bias, ReLU, then LRN and
        pool where the layer has them."""
        z = torch.relu(y + b)
        if layer.lrn:
            z = local_response_norm(z)
        return max_pool(z, s, s) if layer.pool else z

    def _stage_fwd(y, b, layer):
        with torch.no_grad():
            return _stage(y, b, layer)

    def _stage_bwd(y, b, layer, gz):
        with torch.enable_grad():
            y = y.detach().requires_grad_()
            b = b.detach().requires_grad_()
            return torch.autograd.grad(_stage(y, b, layer), (y, b), gz)

    def _head_both(z, head_params, labels, masks, denom):
        """Loss contribution (sum/denom), correct-count, and the grads of
        the loss alone w.r.t. z and every dense layer's params, of one
        microbatch."""
        with torch.enable_grad():
            z = z.detach().requires_grad_()
            hp = {d.name: {k: v.detach().requires_grad_()
                           for k, v in head_params[d.name].items()} for d in dense}
            h = z.reshape(z.shape[0], -1)
            for d, m in zip(dense, masks):
                h = apply_dense(hp[d.name], h)
                if d.relu:
                    h = torch.relu(h)
                if m is not None:
                    h = h * m
            logits = h
            logp = _log_softmax(logits)
            loss = -logp.gather(1, labels[:, None]).sum() / denom
            leaves = [(d.name, k, v) for d in dense for k, v in hp[d.name].items()]
            gz, *gs = torch.autograd.grad(loss, [z] + [v for _, _, v in leaves])
        correct = (logits.argmax(-1) == labels).sum()
        grads = {d.name: {} for d in dense}
        for (name, k, _), g in zip(leaves, gs):
            grads[name][k] = g
        return loss.detach(), correct, gz, grads

    def _warm(mb, params, _size):
        """Run every master-only stage once for this microbatch size, at
        each distinct stage shape of the chain, OUTSIDE the pipeline:
        one-time CUDA handle and allocator warm-up must not pollute the
        cluster's measured non-conv duty (it would strip the master's
        conv share)."""
        h, done = chain.image_size, set()
        for c in convs:
            out = h // s if c.pool else h
            if (h, c.kernels, c.lrn, c.pool) not in done:
                done.add((h, c.kernels, c.lrn, c.pool))
                y = torch.zeros((mb, h, h, c.kernels), device=dev)
                gz = torch.zeros((mb, out, out, c.kernels), device=dev)
                _stage_fwd(y, params[c.name]["bias"], c)
                _stage_bwd(y, params[c.name]["bias"], c, gz)
            h = out
        masks = [torch.zeros((mb, d.units), device=dev) if d.dropout > 0 else None
                 for d in dense]
        _head_both(torch.zeros((mb, h, h, convs[-1].kernels), device=dev), params,
                   torch.zeros((mb,), dtype=torch.long, device=dev), masks, 1.0)

    def _masks(batch, index):
        """This step's dropout masks on ``dev`` (None per layer without)."""
        if not any(d.dropout > 0 for d in dense):
            return [None] * len(dense)
        nbytes = 4 * batch * sum(d.units for d in dense if d.dropout > 0)
        with spans.span("step.masks", nbytes):
            return [None if m is None else m.to(dev)
                    for m in dropout_masks(chain, dropout_seed, index, batch)]

    def _begin(params, batch):
        index = calls[0]
        calls[0] += 1
        masks = _masks(batch, index)
        db = [None] * len(convs)  # conv bias grads, summed over microbatches

        def make_between(k):
            layer, bias = convs[k], params[convs[k].name]["bias"]

            def f(y):
                y = seam(dev, "step.to_card", y=y)
                z = _stage_fwd(y, bias, layer)

                def pull(gz):
                    gy, gb = _stage_bwd(y, bias, layer, seam(dev, "step.to_card", gz=gz))
                    db[k] = gb if db[k] is None else db[k] + gb
                    return handoff(place, "step.to_host", gy=gy)

                return handoff(place, "step.to_host", z=z), pull
            return f

        def head(z, labels, sl, denom):
            return _head_both(z, params, labels,
                              [None if m is None else m[sl] for m in masks], denom)

        def finish(kernels, head_grad):
            new_params = {}
            for k, c in enumerate(convs):
                new_params[c.name] = {"kernel": kernels[k],
                                      "bias": params[c.name]["bias"] - lr * db[k]}
            for d in dense:
                new_params[d.name] = {k: params[d.name][k] - lr * head_grad[d.name][k]
                                      for k in params[d.name]}
            return new_params

        return StepPlan([make_between(k) for k in range(len(convs))], head, finish)

    return cluster_train_step(cluster, dev, lr=lr, kernel_names=[c.name for c in convs],
                              head_layers=len(dense), warm=_warm, begin=_begin)
