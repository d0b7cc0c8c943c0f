"""Three-term roofline of one step on the H100, from the port's per-device
op counts (``op_count.py``).

    compute term    = FLOPs per device      / peak FLOP/s
    memory term     = bytes per device      / HBM bandwidth
    collective term = collective bytes/dev. / link bandwidth

Counterpart of ``repro/roofline/analysis.py``: ``RooflineReport`` keeps
its fields and formulas (``dominant``, ``bound_s``,
``useful_flops_ratio``, ``mfu_upper_bound``), and ``model_flops`` /
``active_params`` its 6·N·D / 2·N·D yardstick.  The counts are per
device already (the dispatch mode sees one rank's shards), so no
division by the chip count enters the terms.

Hardware constants (``HWSpec``), those of the NVIDIA H100 SXM5 80GB
HBM3 at its 700 W limit, from NVIDIA's H100 datasheet:

* 989e12 FLOP/s: dense bf16 on the tensor cores (the sparsity figure
  halved), as ``chip_smoke.py``'s ``PEAK_FLOPS`` takes it;
* 3.35e12 B/s of HBM3 bandwidth (``chip_smoke.py``'s ``PEAK_BYTES_S``);
* 450e9 B/s per direction of NVLink 4 (18 links, 900 GB/s both ways).

The (16, 16) mesh is read as one 256-GPU NVLink Switch domain (the
DGX H100 SuperPOD's NVLink network), the link figure applying to every
collective on it.  The (2, 16, 16) mesh's ``pod`` axis would in fact
cross InfiniBand between two such domains; the single link figure does
not model that (the JAX package's analysis has the same simplification
for its pods).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig


@dataclasses.dataclass(frozen=True)
class HWSpec:
    """One GPU's peak rates (see the module docstring for the sources)."""

    peak_flops: float = 989e12   # dense bf16 FLOP/s per GPU
    hbm_bw: float = 3.35e12      # HBM3 bytes/s per GPU
    link_bw: float = 450e9       # NVLink 4 bytes/s per direction per GPU


HW = HWSpec()


@dataclasses.dataclass
class RooflineReport:
    """One counted step's per-device work and its three roofline terms."""

    arch_id: str
    shape: str
    mesh: str
    tp_mode: str
    chips: int
    # per-device quantities of the counted step
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    # three terms in seconds
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    # "useful compute" accounting
    model_flops: float = 0.0
    bytes_per_device_peak: float = 0.0  # peak live bytes (the HBM footprint)

    def __post_init__(self):
        self.compute_s = self.flops_per_device / HW.peak_flops
        self.memory_s = self.bytes_per_device / HW.hbm_bw
        self.collective_s = self.collective_bytes_per_device / HW.link_bw

    @property
    def dominant(self) -> str:
        """The largest of the three terms: compute, memory or collective."""
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The least time of the step: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — catches remat/redundant
        compute (gather-mode replication shows up here)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """MODEL_FLOPS / (chips x peak x bound_s): the MFU this config
        could at best reach if the dominant term were perfectly hidden."""
        denom = self.chips * HW.peak_flops * self.bound_s
        return self.model_flops / denom if denom else 0.0

    def row(self) -> str:
        """One line for a log."""
        return (
            f"{self.arch_id:24s} {self.shape:12s} {self.mesh:9s} {self.tp_mode:8s} "
            f"C={self.compute_s:9.3e} M={self.memory_s:9.3e} "
            f"X={self.collective_s:9.3e} dom={self.dominant:10s} "
            f"useful={self.useful_flops_ratio:6.1%} mfu<={self.mfu_upper_bound:6.1%}"
        )

    def to_dict(self) -> dict:
        """The fields and the derived terms, for a JSONL record."""
        d = dataclasses.asdict(self)
        d.update(
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, dominant=self.dominant,
            bound_s=self.bound_s, useful_flops_ratio=self.useful_flops_ratio,
            mfu_upper_bound=self.mfu_upper_bound,
        )
        return d


def active_params(cfg: ModelConfig) -> float:
    """Parameter count touched per token (MoE: top-k experts only), from
    the model's params built under ``FakeTensorMode`` (nothing allocated)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_paths

    api = build_model(cfg)
    with FakeTensorMode():
        params = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    total = 0.0
    for path, leaf in tree_paths(params):
        size = float(leaf.numel())
        if cfg.moe is not None and "moe" in path and path[-1] in ("w_in", "w_gate", "w_out"):
            size *= cfg.moe.experts_per_token / cfg.moe.num_experts
        total += size
    return total


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The 6·N·D / 2·N·D "useful model FLOPs" yardstick (N = active
    params, D = tokens processed).  train: fwd+bwd = 6·N·D; prefill:
    2·N·D; decode: 2·N·B (one token per sequence)."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        if cfg.audio is not None:
            d += shape.global_batch * cfg.audio.num_frames
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch  # decode: one new token


def report_from_counts(counter, *, cfg: ModelConfig, shape: InputShape, mesh_name: str,
                       tp_mode: str, chips: int) -> RooflineReport:
    """The ``RooflineReport`` of one counted step (``op_count.OpCounter``)."""
    return RooflineReport(
        arch_id=cfg.arch_id,
        shape=shape.name,
        mesh=mesh_name,
        tp_mode=tp_mode,
        chips=chips,
        flops_per_device=counter.flops,
        bytes_per_device=counter.memory_bytes,
        collective_bytes_per_device=counter.collective_bytes,
        collective_breakdown=dict(counter.by_kind),
        model_flops=model_flops(cfg, shape),
        bytes_per_device_peak=float(counter.peak_bytes),
    )
