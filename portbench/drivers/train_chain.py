"""Training cells of a chain CNN (VGG-16): the configuration's conv
blocks and dense head trained by ``make_cluster_train_step`` over a
``HeteroCluster`` (``conv_train_step``: every conv layer forward and
backward over each device's shard; the stages, the head with its
dropout and plain SGD on the master), as ``train.py`` trains the paper's
CNN.

Set-up builds the cluster (its Eq. 1 probe at conv1_1's geometry), the
params from the seed and the step object, whose dropout masks are
seeded by the seed too, and drives it through its first
``checked_steps`` steps on the stream's first batches; the window goes
on with that object.  ``check`` is ``train.py``'s comparison, against
``reference/vgg16.py`` over the same masks.

Off the card (the harness's CPU tests drive a cell there with the
program's ``cuda`` devices as plain PyTorch ones) the network is cut:
every width divided by ``OFF_CARD_DIVISOR`` (the 1000 classes kept),
images of ``OFF_CARD_SIZE``; the topology and the rest as configured.
"""
from __future__ import annotations

import math
import time

from portbench import traffic_imagenet, work_chain
from portbench.drivers import _common, train
from portbench.reference import vgg16 as reference

OFF_CARD_DIVISOR, OFF_CARD_SIZE = 16, 32


def off_card(cfg: dict) -> dict:
    """``cfg`` cut for a run off the card.  The dense kernels' std rises
    so that the head keeps the published head's gain (the product over
    its layers of std times sqrt(fan-in)), which the cut's fan-ins
    would shrink some 450-fold, leaving logits too near 0 for TF32 to
    move the loss or the gradient."""
    d = OFF_CARD_DIVISOR
    cut = dict(cfg, image_size=OFF_CARD_SIZE,
               blocks=[[w // d for w in block] for block in cfg["blocks"]],
               dense=[u // d for u in cfg["dense"][:-1]] + cfg["dense"][-1:])
    shrink = math.prod(a / b for a, b in zip(_fan_ins(cfg), _fan_ins(cut)))
    cut["dense_init_std"] = cfg["dense_init_std"] * shrink ** (1 / (2 * len(cfg["dense"])))
    return cut


def _fan_ins(cfg: dict) -> list:
    return [work_chain.head_inputs(cfg)] + cfg["dense"][:-1]


def program_config(cfg: dict):
    """The program's ``ConvChainConfig`` for a configuration file."""
    from repro_torch.configs.base import ChainConv, ChainDense, ConvChainConfig

    k, names = cfg["kernel_size"], iter(reference.conv_names(cfg))
    convs = tuple(ChainConv(next(names), width, k, pool=i == len(block) - 1)
                  for block in cfg["blocks"] for i, width in enumerate(block))
    last = len(cfg["dense"]) - 1
    dense = tuple(ChainDense(name, units, relu=j < last, dropout=rate)
                  for j, (name, units, rate) in enumerate(zip(
                      reference.dense_names(cfg), cfg["dense"], cfg["dropout"])))
    return ConvChainConfig(arch_id=cfg["arch_id"], convs=convs, dense=dense,
                           image_size=cfg["image_size"],
                           image_channels=cfg["image_channels"],
                           pool_stride=cfg["pool_stride"], dtype=cfg["dtype"])


def init_params(cfg: dict, seed: int, device):
    """The chain's params drawn on ``device`` from the seed, layer by
    layer: He-normal conv kernels (standard normal times sqrt(2 /
    fan_in), HWIO), dense kernels (in, out) standard normal times
    ``cfg["dense_init_std"]``, zero biases."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    params = {}

    def layer(name, shape, std):
        w = torch.randn(shape, generator=g, device=device) * std
        params[name] = {"kernel": w, "bias": torch.zeros((shape[-1],), device=device)}

    k, cin = cfg["kernel_size"], cfg["image_channels"]
    widths = [w for block in cfg["blocks"] for w in block]
    for name, cout in zip(reference.conv_names(cfg), widths):
        layer(name, (k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))
        cin = cout
    h = cfg["image_size"] // cfg["pool_stride"] ** len(cfg["blocks"])
    n_in = h * h * cin
    for name, units in zip(reference.dense_names(cfg), cfg["dense"]):
        layer(name, (n_in, units), cfg["dense_init_std"])
        n_in = units
    return params


def make_cluster(cell: dict, cfg: dict, backend_map: dict, probe_batch: int):
    """The cell's ``HeteroCluster`` (in-process devices, the kernel
    axis, pipelined microbatches) after its Eq. 1 probe at conv1_1's
    geometry, as the CLI probes."""
    from repro_torch.core.cluster.cluster import HeteroCluster

    backends = [backend_map.get(b, b) for b in cell["backends"]]
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True,
                            microbatches=cell.get("microbatches", 4))
    try:
        cluster.probe(image_size=cfg["image_size"], in_channels=cfg["image_channels"],
                      kernel_size=cfg["kernel_size"],
                      num_kernels=max(8, cfg["blocks"][0][0]), batch=probe_batch)
    except BaseException:
        cluster.shutdown()
        raise
    return cluster


def eq1_record(cluster) -> dict:
    """Eq. 1's inputs and outputs as they stand: each device's probe
    time and backend, the master's measured non-conv duty; the plans
    are per layer (the spans ``cluster.plan``)."""
    return {"backends": list(cluster.backends),
            "probe_s": [float(t) for t in cluster.probe_times],
            "comp_duty": float(cluster.comp_duty)}


class Driver(train.Driver):
    def __init__(self, cell, cfg, seed, seconds, device="cuda", backend_map=None):
        import torch
        # a program without chain configurations stops here, at once
        from repro_torch.configs.base import ConvChainConfig  # noqa: F401
        from repro_torch.models.cnn import make_cluster_train_step

        self.device = torch.device(device)
        cfg = cfg if self.device.type == "cuda" else off_card(cfg)
        self.cell, self.cfg, self.seconds = cell, cfg, seconds
        self.batch, self.lr, self.dropout_seed = cell["batch"], cell["lr"], seed
        self.cluster = make_cluster(cell, cfg, backend_map or {}, self.batch)
        try:
            params = init_params(cfg, seed, self.device)
            self.params0 = train.host(params)
            self.step = make_cluster_train_step(
                self.cluster, program_config(cfg), lr=self.lr, device=device,
                dropout_seed=seed)
            self.stream = traffic_imagenet.synthetic_imagenet_batches(
                self.batch, seed=seed, image_size=cfg["image_size"],
                channels=cfg["image_channels"], num_classes=cfg["num_classes"])
            self.first = [next(self.stream) for _ in range(cell["checked_steps"])]
            self.losses = []
            for i, b in enumerate(self.first):
                params, loss, _ = self.step(params, b["images"], b["labels"])
                self.losses.append(float(loss))
                if i == 0:
                    self.params1 = train.host(params)
            self.params_checked = train.host(params)
            self.params = params
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.eq1 = eq1_record(self.cluster)
        except BaseException:
            self.cluster.shutdown()
            raise
        self._ref = None
        self.detail = False

    def window(self, span) -> dict:
        """Steps begun within ``seconds``; the step in flight at the
        close finishes inside the window."""
        import torch

        before = _common.timing_now(self.cluster)
        steps = nonfinite = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            b = next(self.stream)
            with span("pb.step"):
                self.params, loss, _ = self.step(self.params, b["images"], b["labels"])
            steps += 1
            nonfinite += not math.isfinite(loss)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        return {
            "steps": steps, "images": steps * self.batch, "seconds": elapsed,
            "attempted": steps, "failed": nonfinite,
            "timing": _common.timing_delta(before, self.cluster),
            "eq1_after": eq1_record(self.cluster),
        }

    def _reference(self, **fault):
        return reference.sgd_steps(self.params0, self.first, self.lr, self.cfg,
                                   self.device, self.dropout_seed, **fault)

    def control(self, kind: str) -> dict:
        """The same numbers with the reference in the program's place:
        ``tf32`` (the control), ``half_batch`` (each step's mean over
        half its rows) or ``unchanged`` (a step that returns its state
        unchanged)."""
        if self._ref is None:
            self._ref = self._reference()
        if kind in ("tf32", "half_batch"):
            got = self._reference(**{kind: True})
        elif kind == "unchanged":
            losses = reference.sgd_steps(self.params0, self.first, 0.0, self.cfg,
                                         self.device, self.dropout_seed)[0]
            got = (losses, self.params0, self.params0)
        else:
            raise ValueError(f"unknown control {kind!r}")
        return self._numbers(*got, self._ref)
