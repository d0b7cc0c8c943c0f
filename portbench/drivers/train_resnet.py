"""Training cells of a residual network (ResNet-50): the configuration's
53 convs (projections included) trained by ``make_cluster_train_step``
over a ``HeteroCluster`` (``conv_train_step``: every conv forward and
backward over each device's shard; batch norm, ReLU, the residual adds,
the strides' subsamples, the pools, the head and plain SGD on the
master), as ``train.py`` trains the paper's CNN.

Set-up builds the cluster (its Eq. 1 probe at conv1's geometry), the
params from the seed and the step object, draws a ring of ``ring``
distinct batches from the seed, and drives the step through its first
``checked_steps`` steps on the ring's first batches; the window goes on
with that object, cycling through the ring, so that the images cross to
the card every step as a data loader's would while the host's draw of
a fresh batch stays out of the step.  ``check`` is ``train.py``'s
comparison, against ``reference/resnet50.py`` with batch norm over the
program's microbatches, and two numbers of the first gradient leaf by
leaf besides (``_numbers``).

Off the card (the harness's CPU tests drive a cell there with the
program's ``cuda`` devices as plain PyTorch ones) the network is cut:
every width divided by ``OFF_CARD_DIVISOR`` (the 1000 classes and the
depth kept), images of ``OFF_CARD_SIZE``, ``OFF_CARD_BATCH`` images in
the cell's microbatches, a ring of 4.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench import traffic_imagenet
from portbench.drivers import _common, train
from portbench.reference import resnet50 as reference

OFF_CARD_DIVISOR, OFF_CARD_SIZE, OFF_CARD_BATCH, OFF_CARD_RING = 16, 64, 16, 4


def off_card(cfg: dict) -> dict:
    d = OFF_CARD_DIVISOR
    return dict(cfg, image_size=OFF_CARD_SIZE, stem_width=cfg["stem_width"] // d,
                stages=[dict(s, width=s["width"] // d) for s in cfg["stages"]])


def program_config(cfg: dict):
    """The program's ``ResNetConfig`` for a configuration file."""
    from repro_torch.configs.base import BottleneckStage, ResNetConfig

    return ResNetConfig(
        arch_id=cfg["arch_id"],
        stages=tuple(BottleneckStage(s["width"], s["blocks"], s["stride"])
                     for s in cfg["stages"]),
        image_size=cfg["image_size"], image_channels=cfg["image_channels"],
        stem_width=cfg["stem_width"], stem_kernel=cfg["stem_kernel"],
        expansion=cfg["expansion"], num_classes=cfg["num_classes"],
        bn_eps=cfg["bn_eps"], dtype=cfg["dtype"])


def init_params(cfg: dict, seed: int, device):
    """The params drawn on ``device`` from the seed, leaf by leaf in the
    reference's order: He-normal conv kernels (standard normal times
    sqrt(2 / fan_in), HWIO), each batch norm's gamma 1 and beta 0, the
    fc kernel (in, out) standard normal times ``cfg["dense_init_std"]``
    and a zero bias."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    fan = {}  # conv name -> (k, Cin, Cout)
    cin = cfg["image_channels"]
    fan["conv1"] = (cfg["stem_kernel"], cin, cfg["stem_width"])
    cin = cfg["stem_width"]
    for name, _, proj in reference.blocks(cfg):
        stage = cfg["stages"][int(name[0]) - 2]
        width, cout = stage["width"], cfg["expansion"] * stage["width"]
        if proj:
            fan[f"res{name}_branch1"] = (1, cin, cout)
        fan[f"res{name}_branch2a"] = (1, cin, width)
        fan[f"res{name}_branch2b"] = (3, width, width)
        fan[f"res{name}_branch2c"] = (1, width, cout)
        cin = cout
    params = {}
    for layer, leaf in reference.leaf_names(cfg):
        if layer == "fc1000":
            if leaf == "kernel":
                t = torch.randn((cin, cfg["num_classes"]), generator=g, device=device) \
                    * cfg["dense_init_std"]
            else:
                t = torch.zeros((cfg["num_classes"],), device=device)
        elif leaf == "kernel":
            k, i, o = fan[layer]
            t = torch.randn((k, k, i, o), generator=g, device=device) * math.sqrt(
                2.0 / (k * k * i))
        else:
            n = fan["conv1" if layer == "bn_conv1" else "res" + layer[2:]][2]
            t = (torch.ones if leaf == "gamma" else torch.zeros)((n,), device=device)
        params.setdefault(layer, {})[leaf] = t
    return params


def make_cluster(cell: dict, cfg: dict, backend_map: dict, probe_batch: int):
    """The cell's ``HeteroCluster`` (in-process devices, the kernel
    axis, pipelined microbatches) after its Eq. 1 probe at conv1's
    geometry, as the CLI probes."""
    from repro_torch.core.cluster.cluster import HeteroCluster

    backends = [backend_map.get(b, b) for b in cell["backends"]]
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True,
                            microbatches=cell.get("microbatches", 4))
    try:
        cluster.probe(image_size=cfg["image_size"], in_channels=cfg["image_channels"],
                      kernel_size=cfg["stem_kernel"], num_kernels=max(8, cfg["stem_width"]),
                      batch=probe_batch)
    except BaseException:
        cluster.shutdown()
        raise
    return cluster


def eq1_record(cluster) -> dict:
    return {"backends": list(cluster.backends),
            "probe_s": [float(t) for t in cluster.probe_times],
            "comp_duty": float(cluster.comp_duty)}


class Driver(train.Driver):
    def __init__(self, cell, cfg, seed, seconds, device="cuda", backend_map=None):
        import torch
        # a program without residual configurations stops here, at once
        from repro_torch.configs.base import ResNetConfig  # noqa: F401
        from repro_torch.models.cnn import make_cluster_train_step

        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        cfg = cfg if on_card else off_card(cfg)
        self.cell, self.cfg, self.seconds = cell, cfg, seconds
        self.batch = cell["batch"] if on_card else OFF_CARD_BATCH
        self.lr = cell["lr"]
        self.bn_group = self.batch // cell["microbatches"]
        self.cluster = make_cluster(cell, cfg, backend_map or {}, self.batch)
        try:
            params = init_params(cfg, seed, self.device)
            self.params0 = train.host(params)
            self.step = make_cluster_train_step(
                self.cluster, program_config(cfg), lr=self.lr, device=device)
            stream = traffic_imagenet.synthetic_imagenet_batches(
                self.batch, seed=seed, image_size=cfg["image_size"],
                channels=cfg["image_channels"], num_classes=cfg["num_classes"])
            self.ring = [next(stream) for _ in range(cell["ring"] if on_card
                                                     else OFF_CARD_RING)]
            self.first = self.ring[:cell["checked_steps"]]
            self.losses = []
            for i, b in enumerate(self.first):
                params, loss, _ = self.step(params, b["images"], b["labels"])
                self.losses.append(float(loss))
                if i == 0:
                    self.params1 = train.host(params)
            self.params_checked = train.host(params)
            self.params = params
            if on_card:
                torch.cuda.synchronize()
            self.eq1 = eq1_record(self.cluster)
        except BaseException:
            self.cluster.shutdown()
            raise
        self._ref = None
        self.detail = False

    def window(self, span) -> dict:
        """Steps begun within ``seconds``, on the ring's batches after the
        checked ones, in turn; the step in flight at the close finishes
        inside the window."""
        import torch

        before = _common.timing_now(self.cluster)
        steps = nonfinite = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            b = self.ring[(len(self.first) + steps) % len(self.ring)]
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

    def close(self) -> None:
        super().close()
        self.ring = None

    def _numbers(self, losses, p1, p_last, ref) -> dict:
        """``train.py``'s three numbers, and the largest gap of a counted
        leaf of the first gradient, over the larger of the leaf's
        reference norm and the median leaf's: of their norms
        (``grad_gap_leaf_max``) and of the two gradients' difference
        (``grad_err_leaf_max``).  The whole gradient's norm hides an
        error confined to a few leaves or one that turns a gradient
        without changing its norm; in float32 a leaf reads some 1e-3 to
        1e-2 (ReLU and max-pool flips through batch norm, as plain IEEE
        float32 reads too: ``calibrate_resnet --witness``)."""
        detail = self.detail
        self.detail = True
        try:
            out = super()._numbers(losses, p1, p_last, ref)
        finally:
            self.detail = detail
        more = out.pop("detail")
        gaps, norms = more["grad_gap_by_leaf"], more["ref_grad_norm"]
        median = float(np.median(list(norms.values())))
        got, want = _common.flat(p1), _common.flat(ref[1])
        errs = {k: float(np.linalg.norm(got[k].astype(np.float64) - want[k])) / self.lr
                / max(norms[k], median) for k in gaps}
        out["grad_gap_leaf_max"] = max(gaps.values())
        out["grad_err_leaf_max"] = max(errs.values())
        if detail:
            out["detail"] = dict(more, grad_err_by_leaf=errs)
        return out

    def _reference(self, **fault):
        return reference.sgd_steps(self.params0, self.first, self.lr, self.cfg,
                                   self.device, self.bn_group, **fault)

    def control(self, kind: str) -> dict:
        """The same numbers with the reference in the program's place:
        ``tf32`` (the control), ``fp32`` (plain IEEE float32, a witness
        of what the program's precision gives), ``half_batch`` (each
        step's mean over half its rows), ``drop_shortcut`` (no gradient
        through the shortcuts) or ``unchanged`` (a step that returns its
        state unchanged)."""
        if self._ref is None:
            self._ref = self._reference()
        if kind in ("tf32", "fp32", "half_batch", "drop_shortcut"):
            got = self._reference(**{kind: True})
        elif kind == "unchanged":
            losses = reference.sgd_steps(self.params0, self.first, 0.0, self.cfg,
                                         self.device, self.bn_group)[0]
            got = (losses, self.params0, self.params0)
        else:
            raise ValueError(f"unknown control {kind!r}")
        return self._numbers(*got, self._ref)
