"""What the drivers share: the program's configuration object, the
cluster of a cell, the Eq. 1 record and the cluster's counters."""
from __future__ import annotations

import dataclasses

import numpy as np


def cnn_config(cfg: dict):
    """The program's ``CNNConfig`` for a configuration file."""
    from repro_torch.configs.base import CNNConfig

    return CNNConfig(
        arch_id=cfg["arch_id"], c1_kernels=cfg["c1_kernels"],
        c2_kernels=cfg["c2_kernels"], kernel_size=cfg["kernel_size"],
        image_size=cfg["image_size"], image_channels=cfg["image_channels"],
        num_classes=cfg["num_classes"], pool_stride=cfg["pool_stride"],
        dtype=cfg["dtype"],
    )


def make_cluster(cell: dict, cfg: dict, backend_map: dict, probe_batch: int):
    """The cell's ``HeteroCluster`` (in-process devices, the kernel
    axis, pipelined microbatches: the CLI's defaults) after its Eq. 1
    probe, which runs as the CLI runs it."""
    from repro_torch.core.cluster.cluster import HeteroCluster

    backends = [backend_map.get(b, b) for b in cell["backends"]]
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True,
                            microbatches=cell.get("microbatches", 4))
    try:
        cluster.probe(image_size=cfg["image_size"], in_channels=cfg["image_channels"],
                      kernel_size=cfg["kernel_size"],
                      num_kernels=max(8, cfg["c1_kernels"]), batch=probe_batch)
    except BaseException:
        cluster.shutdown()
        raise
    return cluster


def eq1_record(cluster, cfg: dict) -> dict:
    """Eq. 1's inputs and outputs as they stand: each device's probe
    time and backend, the master's measured non-conv duty, and each conv
    layer's kernels per device."""
    return {
        "backends": list(cluster.backends),
        "probe_s": [float(t) for t in cluster.probe_times],
        "comp_duty": float(cluster.comp_duty),
        "c1_kernels_per_device": cluster.shares_for(cfg["c1_kernels"]).tolist(),
        "c2_kernels_per_device": cluster.shares_for(cfg["c2_kernels"]).tolist(),
    }


def cpu_kernel_share(cluster, cell: dict, cfg: dict) -> float:
    """The share of conv2's kernels on the devices the cell does not
    name ``cuda``."""
    counts = cluster.shares_for(cfg["c2_kernels"])
    cpu = sum(int(c) for c, b in zip(counts, cell["backends"]) if b != "cuda")
    return cpu / cfg["c2_kernels"]


def timing_delta(before: dict, cluster) -> dict:
    after = dataclasses.asdict(cluster.timing)
    return {k: after[k] - before[k] for k in after}


def timing_now(cluster) -> dict:
    return dataclasses.asdict(cluster.timing)


def flat(params: dict) -> dict:
    return {f"{l}.{n}": np.asarray(v) for l, d in params.items() for n, v in d.items()}
