"""Training cells: the paper's CNN trained by ``make_cluster_train_step``
over a ``HeteroCluster`` (``conv_train_step``: both conv layers forward
and backward over every device's shard, the master stages on the card,
plain SGD).

Set-up builds one step object from the seed and drives it through its
first ``checked_steps`` steps, on the stream's first batches, through
the same call and feed as the window; the window then goes on with that
object.  ``check`` follows those first steps with the plain reference
(float64) from the same initial params and batches and compares the
first step's loss, the norm of the first gradient as SGD got it
((p0 - p1) / lr) and the params' change after the checked steps (by
the median leaf).
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from portbench import traffic
from portbench.drivers import _common
from portbench.reference import cifar_cnn as reference

# leaves whose reference gradient is below this share of the median
# leaf's are left out of the norm comparisons (round-off moves them)
NOUGHT_SHARE = 1e-3


def init_params(cfg: dict, seed: int, device):
    """The CNN's params drawn on ``device`` from the seed, in three
    calls: fan-in scaled normal conv kernels (HWIO) and fc kernel (in,
    out), zero biases: ``init_cnn``'s law."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    k, c0 = cfg["kernel_size"], cfg["image_channels"]
    c1, c2 = cfg["c1_kernels"], cfg["c2_kernels"]
    feat = (cfg["image_size"] // cfg["pool_stride"] ** 2) ** 2 * c2

    def normal(shape, fan_in):
        return torch.randn(shape, generator=g, device=device) / math.sqrt(fan_in)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        "conv1": {"kernel": normal((k, k, c0, c1), k * k * c0), "bias": zeros(c1)},
        "conv2": {"kernel": normal((k, k, c1, c2), k * k * c1), "bias": zeros(c2)},
        "fc": {"kernel": normal((feat, cfg["num_classes"]), feat),
               "bias": zeros(cfg["num_classes"])},
    }


def _leaf_gaps(got: dict, want: dict, counted) -> dict:
    """Each counted leaf's |‖got‖ - ‖want‖| over the larger of ‖want‖
    and the median leaf's ‖want‖ (float64 arrays)."""
    norm = {k: float(np.linalg.norm(v)) for k, v in want.items()}
    median = float(np.median(list(norm.values())))
    return {k: abs(float(np.linalg.norm(got[k])) - norm[k]) / max(norm[k], median)
            for k in counted}


def host(params) -> dict:
    return {l: {n: t.detach().cpu().numpy().copy() for n, t in d.items()}
            for l, d in params.items()}


class Driver:
    def __init__(self, cell, cfg, seed, seconds, device="cuda", backend_map=None):
        import torch
        from repro_torch.models.cnn import make_cluster_train_step

        self.cell, self.cfg, self.seconds = cell, cfg, seconds
        self.device = torch.device(device)
        self.batch, self.lr = cell["batch"], cell["lr"]
        self.cluster = _common.make_cluster(cell, cfg, backend_map or {}, self.batch)
        try:
            params = init_params(cfg, seed, self.device)
            self.params0 = host(params)
            self.step = make_cluster_train_step(
                self.cluster, _common.cnn_config(cfg), lr=self.lr, device=device)
            self.stream = traffic.synthetic_cifar_batches(
                self.batch, seed=seed, image_size=cfg["image_size"],
                channels=cfg["image_channels"], num_classes=cfg["num_classes"])
            self.first = [next(self.stream) for _ in range(cell["checked_steps"])]
            self.losses = []
            for i, b in enumerate(self.first):
                params, loss, _ = self.step(params, b["images"], b["labels"])
                self.losses.append(float(loss))
                if i == 0:
                    self.params1 = host(params)
            self.params_checked = host(params)
            self.params = params
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.eq1 = _common.eq1_record(self.cluster, cfg)
        except BaseException:
            self.cluster.shutdown()
            raise
        self._ref = None
        self.detail = False  # calibrate.py's per-step and per-leaf readings

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
            "cpu_kernel_share": _common.cpu_kernel_share(self.cluster, self.cell, self.cfg),
            "eq1_after": _common.eq1_record(self.cluster, self.cfg),
        }

    def close(self) -> None:
        import torch

        self.cluster.shutdown()
        self.params = self.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------
    def _reference(self, **fault):
        return reference.sgd_steps(self.params0, self.first, self.lr, self.cfg,
                                   self.device, **fault)

    def _numbers(self, losses, p1, p_last, ref) -> dict:
        """The first step's loss gap; the gap of the norm of the whole
        first gradient as SGD got it ((p0 - p1) / lr, every counted leaf
        in one vector); and the median counted leaf's gap of norms of the
        change after the checked steps, each leaf's over the larger of its
        reference norm and the median leaf's.  All relative.  Neither
        norm is taken by the worst leaf: in float32 a max-pool's near-tie
        or a ReLU at 0 flips on a few seeds and moves a conv leaf's norm
        by 1e-6 to 1e-5, as far as TF32 moves it (PERF.md)."""
        ref_losses, ref_p1, ref_last = ref
        p0 = _common.flat(self.params0)
        f64 = {k: v.astype(np.float64) for k, v in p0.items()}
        g_ref = {k: (f64[k] - v) / self.lr for k, v in _common.flat(ref_p1).items()}
        g_got = {k: (f64[k] - v) / self.lr for k, v in _common.flat(p1).items()}
        norms = {k: float(np.linalg.norm(v)) for k, v in g_ref.items()}
        median = float(np.median(list(norms.values())))
        counted = [k for k, n in norms.items() if n >= NOUGHT_SHARE * median]
        d_ref = {k: v - f64[k] for k, v in _common.flat(ref_last).items()}
        d_got = {k: v - f64[k] for k, v in _common.flat(p_last).items()}
        g_gaps = _leaf_gaps(g_got, g_ref, counted)
        d_gaps = _leaf_gaps(d_got, d_ref, counted)
        steps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]

        def whole(tree):
            return math.sqrt(sum(float(np.sum(np.square(tree[k]))) for k in counted))

        out = {
            "loss_gap_step1": steps[0],
            "grad_norm_gap": abs(whole(g_got) - whole(g_ref)) / whole(g_ref),
            "change_norm_gap_median": float(np.median(list(d_gaps.values()))),
        }
        if self.detail:
            out["detail"] = {"loss_gap_by_step": steps, "ref_grad_norm": norms,
                             "grad_gap_by_leaf": g_gaps, "change_gap_by_leaf": d_gaps,
                             "grad_gap_median": float(np.median(list(g_gaps.values())))}
        return out

    def check(self) -> dict:
        """The timed path's first steps against the plain reference."""
        if self._ref is None:
            self._ref = self._reference()
        return self._numbers(self.losses, self.params1, self.params_checked, self._ref)

    def control(self, kind: str) -> dict:
        """The same numbers with the reference in the program's place:
        ``tf32`` (the control), ``half_batch`` (each step's mean over
        half its rows), ``no_exchange`` (the non-master devices'
        channels never gathered) or ``unchanged`` (a step that returns
        its state unchanged)."""
        if self._ref is None:
            self._ref = self._reference()
        if kind == "tf32":
            got = self._reference(tf32=True)
        elif kind == "half_batch":
            got = self._reference(half_batch=True)
        elif kind == "no_exchange":
            got = self._reference(drop_channels=[
                np.arange(c[0], sum(c)) for c in
                (self.eq1["c1_kernels_per_device"], self.eq1["c2_kernels_per_device"])])
        elif kind == "unchanged":
            losses = reference.sgd_steps(self.params0, self.first, 0.0, self.cfg,
                                         self.device)[0]
            got = (losses, self.params0, self.params0)
        else:
            raise ValueError(f"unknown control {kind!r}")
        return self._numbers(*got, self._ref)
