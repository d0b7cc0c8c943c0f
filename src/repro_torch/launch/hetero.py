"""Train and serve the paper's CNN over the heterogeneous cluster, on
the card.

The port's counterpart of ``repro/launch/hetero.py``: one CLI over
per-device conv backends (core/backends.py), Eq. 1 probing and
partitioning, and the scatter/gather protocol (core/cluster/), with the
CPU/GPU device mix.  Three modes:

``--train-pipeline`` runs full training steps through the
activation-stashing schedule (``make_cluster_train_step`` ->
``HeteroCluster.conv_train_step``): forward and backward of both conv
layers are distributed — on a ``cuda`` device the hand-written Hopper
kernels K1 (forward), K2 (dX) and K3 (dW) — while the master-only
stages (bias, ReLU, LRN, pool, fc, softmax loss) run as PyTorch on the
master's device and overlap slave compute:

    PYTHONPATH=src python -m repro_torch.launch.hetero --train-pipeline \
        --backends cuda,cuda,numpy --slowdowns 1,1,1 \
        --c1 500 --c2 1500 --batch 32 --microbatches 4 --steps 3

``--arch`` picks the network: the paper's CIFAR-10 CNN by ``--c1`` and
``--c2`` (the default), a ``cifar_cnn_*`` id, or ``vgg16`` (VGG-16,
configuration D of arXiv:1409.1556 at 224x224: 13 convs, each a layer of
the cluster, and a dense head with dropout) or ``resnet50`` (ResNet-50,
arXiv:1512.03385 Table 1 at 224x224: 53 convs, projections included,
each a layer of the cluster; batch norm, the residual adds, the pools
and the head in the master's stages), which train through
``--train-pipeline`` only, by SGD at ``configs/vgg16.SGD_LR`` and
``configs/resnet50.SGD_LR`` (the paper's CNN at 0.05):

    PYTHONPATH=src python -m repro_torch.launch.hetero --train-pipeline \
        --arch vgg16 --backends cuda --slowdowns 1 --batch 32 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.hetero --train-pipeline \
        --arch resnet50 --backends cuda --slowdowns 1 --batch 128 --steps 3

``--pipeline`` (and, without it, the barrier protocol) runs the
autograd step of ``cnn_loss`` with the cluster as its conv
(``make_distributed_conv``).  ``--serve`` serves requests through the
continuous-batching ``ClusterServer`` (serve/server.py) and the
cross-batch ``ServeChain`` pipeline:

    PYTHONPATH=src python -m repro_torch.launch.hetero --serve \
        --backends cuda,cuda,numpy --slowdowns 1,1,1 \
        --c1 500 --c2 1500 --image-size 32 --requests 16 --max-batch 4

``--device`` picks the default backend of every device not named by
``--backends`` and the device of the master-only stages: ``cuda`` (the
default: the hand-written kernels on the card) or ``cpu``
(``torch:cpu``, the plain PyTorch conv, and the stages on the CPU).
``--device cuda`` on a host without a card is an error, never a CPU
run.

``--groups GxM`` trains over the two-tier hierarchy
(``core/cluster/hierarchy.py``): a root (device 0) over G sub-master
groups of M devices each.  The root splits each batch's samples across
the groups by their aggregate Eq. 1 capacity and sums their full dW;
each group re-partitions its rows on ``--group-partition``.
``--slowdowns`` and ``--backends`` give the root and then the G*M group
devices in order, or the root alone (the group devices then run at
slowdown 1 on ``--device``'s backend).  With ``--transport tcp`` each
sub-master is an OS process with its group inside it as threads:

    PYTHONPATH=src python -m repro_torch.launch.hetero --train-pipeline \
        --groups 2x2 --backends cuda,cuda,numpy,cuda,numpy \
        --group-partition kernel --c1 500 --c2 1500 --batch 32 --steps 3

Training draws its params from ``init_cnn`` (``init_chain`` for
``vgg16``, ``init_resnet`` for ``resnet50``) with a ``torch.Generator``
seeded 0, its images from one seeded 1 (``train_inputs``) and its
dropout masks from seed 0; they
cannot equal ``jax.random``'s draws, so parity with the JAX package is
tested by carrying its params across (``convert.py``).  Serving draws
identical weights and requests from numpy's generator in both CLIs
(``run_serve``'s ``seed``, 0 on the command line).  The CLI always
leaves through ``os._exit`` after flushing its output, so no native
runtime thread can hang the interpreter at exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config, resnet50, vgg16
from repro_torch.configs.base import ConvChainConfig, ResNetConfig
from repro_torch.core.cluster.cluster import HeteroCluster, make_distributed_conv
from repro_torch.core.partitioner import workload_shares
from repro_torch.models.cnn import (
    cnn_loss,
    conv_chain,
    init_chain,
    init_cnn,
    make_cluster_train_step,
    make_cnn_config,
)
from repro_torch.models.resnet import init_resnet, resnet_layers

# the conv backend each device runs when ``backends`` names none
DEVICE_BACKENDS = {"cuda": "cuda", "cpu": "torch:cpu"}


def serve_inputs(seed: int, c1: int, c2: int, image_size: int, requests: int):
    """The serve lane's weights and requests, drawn from one numpy
    generator in the JAX lane's order: the two 5x5 conv kernels, the fc
    matrix, then one (image_size, image_size, 3) image per request.
    Returns ``(conv_kernels, fc, images)``."""
    rng = np.random.default_rng(seed)
    k = 5
    weights = [
        rng.standard_normal((k, k, 3, c1)).astype(np.float32) * 0.1,
        rng.standard_normal((k, k, c1, c2)).astype(np.float32) * 0.1,
    ]
    feat = image_size // 4
    fc = rng.standard_normal((feat * feat * c2, 10)).astype(np.float32) * 0.01
    images = [
        rng.standard_normal((image_size, image_size, 3)).astype(np.float32)
        for _ in range(requests)
    ]
    return weights, fc, images


def relu_pool(y: np.ndarray) -> np.ndarray:
    """Master-only stage after each conv: ReLU + 2x2 max-pool (numpy —
    the serve loop drives the cluster directly)."""
    y = np.maximum(y, 0.0)
    b, h, w, c = y.shape
    return y.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))


def train_inputs(cfg, batch: int, device):
    """The training run's params and batch on ``device``: ``init_cnn``
    (``init_chain`` for a ``ConvChainConfig``, ``init_resnet`` for a
    ``ResNetConfig``) from a ``torch.Generator`` seeded 0,
    standard-normal images from one seeded 1, labels
    ``arange(batch) % num_classes``.  Drawn on the CPU, so the CPU and
    the card get the same numbers.
    Returns ``(params, images, labels)``."""
    init = (init_chain if isinstance(cfg, ConvChainConfig)
            else init_resnet if isinstance(cfg, ResNetConfig) else init_cnn)
    params = init(torch.Generator().manual_seed(0), cfg, device)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.image_channels)
    images = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    labels = torch.arange(batch) % cfg.num_classes
    return params, images.to(device), labels.to(device)


def sgd_step(params, loss_fn, lr: float):
    """One autograd SGD step: ``loss_fn(params) -> (loss, acc)``;
    returns ``(new_params, loss, acc)`` with every leaf moved by
    ``-lr * grad``."""
    names = [(layer, name) for layer in params for name in params[layer]]
    leaves = [params[l][n].detach().requires_grad_() for l, n in names]
    q = {layer: {} for layer in params}
    for (l, n), t in zip(names, leaves):
        q[l][n] = t
    loss, acc = loss_fn(q)
    grads = torch.autograd.grad(loss, leaves)
    new = {layer: {} for layer in params}
    for (l, n), t, g in zip(names, leaves, grads):
        new[l][n] = (t - lr * g).detach()
    return new, float(loss.detach()), float(acc)


def run_hetero(
    slowdowns,
    backends=None,
    *,
    device: str = "cuda",
    pipeline: bool = False,
    train_pipeline: bool = False,
    microbatches: int = 4,
    c1: int = 8,
    c2: int = 16,
    batch: int = 8,
    steps: int = 2,
    lr: float = 0.05,
    partition: str = "kernel",
    wire_dtype=None,
    wire_codec=None,
    weight_cache: bool = True,
    bandwidth_mbps=None,
    transport: str = "inproc",
    expected_slaves=None,
    listen_host: str = "127.0.0.1",
    listen_port: int = 0,
    heartbeat_s=None,
    groups=None,
    group_partition: str = "auto",
    master_nic_mbps=None,
    cfg=None,
):
    """``steps`` training steps of a CNN over the cluster, all on the
    same batch (``train_inputs``): ``cfg``, or the paper's CNN at
    ``c1``/``c2`` kernels.  With ``train_pipeline`` the pipelined full
    step (``make_cluster_train_step``); otherwise the autograd step of
    the paper's CNN with the cluster as its conv
    (``make_distributed_conv``), microbatched when ``pipeline``.  A
    ``ConvChainConfig`` or a ``ResNetConfig`` trains through
    ``train_pipeline`` only.

    ``groups`` (a ``"GxM"`` topology) trains over a
    ``HierarchicalCluster`` instead: device 0 is the root, the batch
    axis splits samples across the groups, and each group partitions
    its rows on ``group_partition``.  ``slowdowns`` and ``backends``
    then carry the root and the G*M group devices, or the root alone;
    group devices without a backend take ``device``'s.

    Returns ``(rec, history)``: the JSON-ready record (losses, wall
    time, Eq. 1 probe times, the timing breakdown and comp-aware duty;
    with ``groups``, each in-process group's inner shares) and the
    params after each step, in order."""
    cfg = make_cnn_config(c1, c2) if cfg is None else cfg
    if isinstance(cfg, (ConvChainConfig, ResNetConfig)) and not train_pipeline:
        raise SystemExit(f"{cfg.arch_id} trains through --train-pipeline only")
    # each conv layer's kernels, by the names the record has kept, and
    # the first conv's kernel size, the geometry of the Eq. 1 probe
    if isinstance(cfg, ResNetConfig):
        widths = {l.name: l.cout for l in resnet_layers(cfg)}
        first_k = cfg.stem_kernel
    else:
        chain = conv_chain(cfg)
        widths = ({"c1": cfg.c1_kernels, "c2": cfg.c2_kernels} if chain is not cfg
                  else {c.name: c.kernels for c in chain.convs})
        first_k = chain.convs[0].kernel_size
    last = list(widths)[-1]
    if groups is not None:
        from repro_torch.core.cluster.hierarchy import (
            HierarchicalCluster,
            parse_groups,
        )

        if expected_slaves is not None:
            raise SystemExit(
                "--groups spawns its own sub-masters; --expected-slaves "
                "(hand-launched joins) is a flat-cluster feature"
            )
        n_devices = 1 + sum(g.size for g in parse_groups(groups))
        if backends is None or len(backends) == 1:
            # the group devices take --device's backend, never the
            # hierarchy's own default
            root = backends[0] if backends else DEVICE_BACKENDS[device]
            backends = [root] + [DEVICE_BACKENDS[device]] * (n_devices - 1)
        gspecs = parse_groups(
            groups,
            slowdowns=slowdowns[1:] if len(slowdowns) > 1 else None,
            backends=backends[1:],
            partition=group_partition,
            pipeline=pipeline or train_pipeline,
            microbatches=microbatches,
        )
        cluster = HierarchicalCluster(
            gspecs,
            master_slowdown=slowdowns[0],
            master_backend=backends[0],
            pipeline=pipeline or train_pipeline, microbatches=microbatches,
            wire_dtype=wire_dtype, wire_codec=wire_codec,
            weight_cache=weight_cache, bandwidth_mbps=bandwidth_mbps,
            master_nic_mbps=master_nic_mbps, transport=transport,
            heartbeat_s=heartbeat_s,
        )
        partition = "batch"  # the root's inter-group axis, by construction
    else:
        if backends is None:
            backends = [DEVICE_BACKENDS[device]] * len(slowdowns)
        cluster = HeteroCluster(
            slowdowns, backends,
            pipeline=pipeline or train_pipeline, microbatches=microbatches,
            partition=partition, wire_dtype=wire_dtype,
            wire_codec=wire_codec, weight_cache=weight_cache,
            bandwidth_mbps=bandwidth_mbps, transport=transport,
            expected_slaves=expected_slaves,
            listen_host=listen_host, listen_port=listen_port,
            heartbeat_s=heartbeat_s, master_nic_mbps=master_nic_mbps,
        )
    try:
        probe = cluster.probe(
            image_size=cfg.image_size, in_channels=cfg.image_channels,
            kernel_size=first_k, num_kernels=max(8, next(iter(widths.values()))),
            batch=batch,
        )
        shares = workload_shares(probe)
        print(f"devices: slowdowns={list(cluster.slowdowns)} "
              f"backends={cluster.backends} transport={transport} "
              f"master stages on {device}"
              + (f" topology={groups} (groups plan rows internally on "
                 f"'{group_partition}')" if groups else ""))
        print(f"probe times: {np.round(probe, 4).tolist()}")
        if transport in ("tcp", "shm"):
            print(f"measured link bandwidth (Mbps): "
                  f"{[None if b is None else round(b, 1) for b in cluster.measured_bandwidths]}")
        print(f"Eq.1 shares: {np.round(shares, 3).tolist()} -> "
              f"{last} kernels {cluster.shares_for(widths[last]).tolist()}")
        # in-process groups only: tcp/shm groups live inside their
        # sub-master processes
        group_shares = [
            [float(s) for s in workload_shares(g.probe_times)]
            for g in getattr(cluster, "group_clusters", [])
        ] or None
        if group_shares:
            print(f"group shares: {np.round(group_shares, 3).tolist()}")

        params, imgs, labels = train_inputs(cfg, batch, device)
        if train_pipeline:
            # full-step pipeline: fwd + bwd distributed, direct driver
            cluster_step = make_cluster_train_step(cluster, cfg, lr=lr,
                                                   device=device)

            def train_step(p):
                p, loss, _acc = cluster_step(p, imgs, labels)
                return p, loss
        else:
            # autograd step with the cluster as the conv
            conv_fn = make_distributed_conv(cluster)

            def train_step(p):
                p, loss, _acc = sgd_step(
                    p, lambda q: cnn_loss(q, imgs, labels, cfg=cfg,
                                          conv_fn=conv_fn), lr)
                return p, loss

        cluster.reset_stats()
        t0 = time.perf_counter()
        losses, history = [], []
        for _ in range(steps):
            params, loss = train_step(params)
            losses.append(float(loss))
            history.append(params)
        wall = time.perf_counter() - t0

        t = cluster.timing
        rec = {
            "protocol": (
                "trainstep-pipelined" if train_pipeline
                else "pipelined" if pipeline else "barrier"
            ),
            "device": device,
            "transport": transport,
            "topology": groups or "flat",
            "group_partition": group_partition if groups else None,
            "group_shares": group_shares,
            "master_nic_mbps": master_nic_mbps,
            "measured_bandwidth_mbps": list(cluster.measured_bandwidths),
            "microbatches": microbatches if (pipeline or train_pipeline) else 1,
            "partition": partition,
            "partition_choices": {
                str(k): v for k, v in cluster.partition_choices.items()
            },
            "wire_dtype": wire_dtype or "fp32",
            "wire_codec": cluster._codec_cfg.spec,
            "weight_cache": weight_cache,
            "bandwidth_mbps": bandwidth_mbps,
            "heartbeat_s": heartbeat_s,
            "slave_ids": list(cluster.slave_ids),
            "failures": list(cluster.failures),
            "comp_duty": cluster.comp_duty,
            "backends": list(cluster.backends),
            "probe_s": [float(x) for x in probe],
            "shares": [float(s) for s in shares],
            "arch": cfg.arch_id,
            "kernels_per_device": {
                name: cluster.shares_for(n).tolist() for name, n in widths.items()
            },
            "losses": losses,
            "wall_s": wall,
            "comm_mb": cluster.comm_bytes / 2 ** 20,
            "timing": dataclasses.asdict(t),
        }
        print(f"{steps} steps in {wall:.2f}s  losses={np.round(losses, 4).tolist()}")
        print(f"comm={rec['comm_mb']:.1f}MiB  scatter={t.comm_s:.3f}s "
              f"conv={t.conv_s:.3f}s wait={t.gather_wait_s:.3f}s "
              f"overlap={t.overlap_s:.3f}s")
        if train_pipeline:
            print(f"comp-aware: master non-conv duty={cluster.comp_duty:.2f} -> "
                  f"{last} kernels now {cluster.shares_for(widths[last]).tolist()}")
        if partition == "auto" and cluster.partition_choices:
            print(f"auto partition picks: {rec['partition_choices']}")
        return rec, history
    finally:
        cluster.shutdown()


def run_serve(
    slowdowns,
    backends=None,
    *,
    device: str = "cuda",
    microbatches: int = 4,
    c1: int = 8,
    c2: int = 16,
    requests: int = 20,
    deadline_s=30.0,
    max_batch: int = 4,
    image_size: int = 16,
    partition: str = "kernel",
    wire_dtype=None,
    wire_codec=None,
    weight_cache: bool = True,
    bandwidth_mbps=None,
    transport: str = "inproc",
    expected_slaves=None,
    listen_host: str = "127.0.0.1",
    listen_port: int = 0,
    heartbeat_s=None,
    seed: int = 0,
):
    """Serve ``requests`` synthetic conv-chain requests through a
    ``ClusterServer`` (continuous batching over the pipelined cluster)
    and report throughput + tail latency.

    Returns ``(rec, outputs)``: the JSON-ready record — ``all_ok`` says
    whether every request completed under its deadline, ``probe_s`` and
    ``shares`` are the Eq. 1 inputs and outputs — and the served head
    outputs in request order (None for a request that did not finish
    ``ok``)."""
    from repro_torch.serve.server import ClusterServer

    if backends is None:
        backends = [DEVICE_BACKENDS[device]] * len(slowdowns)
    weights, fc, images = serve_inputs(seed, c1, c2, image_size, requests)

    def _head(z):
        return z.reshape(z.shape[0], -1) @ fc

    cluster = HeteroCluster(
        slowdowns, backends,
        pipeline=True, microbatches=microbatches,
        partition=partition, wire_dtype=wire_dtype,
        wire_codec=wire_codec, weight_cache=weight_cache,
        bandwidth_mbps=bandwidth_mbps, transport=transport,
        expected_slaves=expected_slaves,
        listen_host=listen_host, listen_port=listen_port,
        heartbeat_s=heartbeat_s,
    )
    try:
        probe = cluster.probe(image_size=image_size, in_channels=3,
                              kernel_size=5, num_kernels=max(8, c1),
                              batch=max_batch)
        shares = workload_shares(probe)
        print(f"serving: slowdowns={list(cluster.slowdowns)} "
              f"backends={cluster.backends} transport={transport} "
              f"max_batch={max_batch} deadline_s={deadline_s}")
        print(f"probe times: {np.round(probe, 4).tolist()}")
        print(f"Eq.1 shares: {np.round(shares, 3).tolist()} -> "
              f"c1 kernels {cluster.shares_for(c1).tolist()} "
              f"c2 kernels {cluster.shares_for(c2).tolist()}")
        server = ClusterServer(
            cluster, weights, between=[relu_pool, relu_pool], head=_head,
            max_batch=max_batch, max_queue=max(2 * requests, 16),
            default_deadline_s=deadline_s,
        )
        t0 = time.perf_counter()
        with server:
            futs = [server.submit(img) for img in images]
            resps = [f.result(timeout=600.0) for f in futs]
        wall = time.perf_counter() - t0
        stats = server.stats()
        statuses = sorted({r.status for r in resps})
        all_ok = all(r.status == "ok" for r in resps)
        rec = {
            "mode": "serve",
            "device": device,
            "backends": list(cluster.backends),
            "transport": transport,
            "partition": partition,
            "wire_codec": cluster._codec_cfg.spec,
            "weight_cache": weight_cache,
            "c1": c1,
            "c2": c2,
            "image_size": image_size,
            "probe_s": [float(t) for t in probe],
            "shares": [float(s) for s in shares],
            "kernels_per_device": {
                "c1": cluster.shares_for(c1).tolist(),
                "c2": cluster.shares_for(c2).tolist(),
            },
            "requests": requests,
            "max_batch": max_batch,
            "deadline_s": deadline_s,
            "statuses": statuses,
            "all_ok": all_ok,
            "retries": sum(r.retries for r in resps),
            "failures": list(cluster.failures),
            "wall_s": wall,
            "throughput_rps": requests / wall,
            "p50_ms": stats["p50_ms"],
            "p99_ms": stats["p99_ms"],
            "comm_mb": cluster.comm_bytes / 2 ** 20,
            "timing": dataclasses.asdict(cluster.timing),
        }
        print(f"{requests} requests in {wall:.2f}s -> "
              f"{rec['throughput_rps']:.1f} req/s  "
              f"p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms  "
              f"statuses={statuses} retries={rec['retries']}")
        return rec, [r.output for r in resps]
    finally:
        cluster.shutdown()


def _clean_exit(code: int) -> None:
    """Flush and leave through ``os._exit``: a process holding native
    runtime threads (a CUDA context) cannot hang CPython finalization
    if it skips finalization.  Everything user-visible (stdout/stderr,
    --out JSONL) is already written and flushed by the time this runs,
    so nothing is lost."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def main():
    """The command line (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--slowdowns", default=None,
                    help="comma list; device 0 is the master (default "
                         "1.0,1.5,3.0 flat; with --groups GxM pass 1 + G*M "
                         "entries — root then group devices chunked M per "
                         "group — or just the root, group devices default "
                         "to 1.0)")
    ap.add_argument("--backends", default=None,
                    help="comma list of conv backends per device "
                         "(cuda|torch[:cpu|:cuda]|numpy|sim); default: "
                         "--device's backend everywhere")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the default backend of every device and the "
                         "device of the master-only stages: cuda (the "
                         "hand-written kernels; the default) or cpu "
                         "(torch:cpu, the plain PyTorch conv)")
    ap.add_argument("--serve", action="store_true",
                    help="serve a stream of forward-pass requests through "
                         "the continuous-batching ClusterServer; exits "
                         "nonzero unless every request completes under "
                         "deadline")
    ap.add_argument("--pipeline", action="store_true",
                    help="microbatched, double-buffered scatter/gather "
                         "(default: barrier protocol)")
    ap.add_argument("--train-pipeline", action="store_true",
                    help="pipeline the FULL train step (fwd+bwd of every "
                         "conv layer, master-only stages overlapped)")
    ap.add_argument("--groups", default=None, metavar="GxM",
                    help="two-tier topology: G sub-master groups of M "
                         "devices each (e.g. 2x3); the root plans disjoint "
                         "batch rows across groups (exact dW all-reduce), "
                         "each group re-partitions its rows internally on "
                         "--group-partition.  With --transport tcp each "
                         "sub-master is a real OS process")
    ap.add_argument("--group-partition", default="auto",
                    choices=["kernel", "spatial", "batch", "auto"],
                    help="conv split axis INSIDE each group (the root's "
                         "inter-group axis is always batch)")
    ap.add_argument("--master-nic-mbps", type=float, default=None,
                    help="emulate ONE shared master port of this speed "
                         "serialized across all root links (inproc only)")
    ap.add_argument("--partition", default="kernel",
                    choices=["kernel", "spatial", "batch", "auto"],
                    help="conv split axis: output channels (kernel, the "
                         "paper), height strips + halo exchange (spatial), "
                         "batch rows + replicated kernel (batch), or "
                         "per-layer predicted-wall-clock pick (auto)")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["fp32", "fp16", "bf16"],
                    help="compact wire codec at the socket boundary; "
                         "master-side accumulation stays float32")
    ap.add_argument("--wire-codec", default=None,
                    help="full compressor stack, superseding --wire-dtype, "
                         "e.g. 'fp16' or 'weights=fp16,acts=int8'")
    ap.add_argument("--no-weight-cache", action="store_true",
                    help="disable the versioned weight-broadcast cache")
    ap.add_argument("--bandwidth-mbps", type=float, default=None,
                    help="emulated master<->slave link speed; default: "
                         "infinitely fast links")
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "tcp", "shm"],
                    help="the wire: in-process queues (threads), localhost "
                         "TCP with one OS subprocess per slave, or shm "
                         "rings (co-located subprocesses)")
    ap.add_argument("--expected-slaves", type=int, default=None,
                    help="wait for this many hand-launched slaves to join "
                         "instead of spawning any (implies --transport tcp)")
    ap.add_argument("--listen-host", default="127.0.0.1",
                    help="TCP listener bind interface")
    ap.add_argument("--listen-port", type=int, default=0,
                    help="TCP listener port (0 = kernel-assigned)")
    ap.add_argument("--heartbeat-s", type=float, default=None,
                    help="slave liveness interval (tcp only)")
    ap.add_argument("--requests", type=int, default=20,
                    help="synthetic requests to serve")
    ap.add_argument("--deadline-s", type=float, default=30.0,
                    help="per-request deadline")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="dynamic-batching slot count")
    ap.add_argument("--image-size", type=int, default=16,
                    help="request image height/width")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--arch", default=None,
                    help="the network trained: a cifar_cnn_* id, vgg16 "
                         "(VGG-16 at 224x224) or resnet50 (ResNet-50 at "
                         "224x224), the last two --train-pipeline only; "
                         "default: the paper's CNN at --c1/--c2")
    ap.add_argument("--c1", type=int, default=8)
    ap.add_argument("--c2", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None, help="append the record as JSONL")
    args = ap.parse_args()

    if args.arch and (args.serve or not args.train_pipeline):
        raise SystemExit("--arch trains through --train-pipeline; --serve and the "
                         "other protocols run the paper's CNN at --c1/--c2")
    cfg = get_config(args.arch) if args.arch else None
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: --device cuda (the default) needs a CUDA card "
            "and torch.cuda.is_available() is False; pass --device cpu to "
            "run the plain PyTorch conv on the CPU"
        )
    # the flat default topology makes no sense under --groups: there the
    # default is "just the root", group devices filling in at 1.0
    slowdowns_s = args.slowdowns or ("1.0" if args.groups else "1.0,1.5,3.0")
    slowdowns = [float(s) for s in slowdowns_s.split(",")]
    backends = args.backends.split(",") if args.backends else None
    transport = "tcp" if args.expected_slaves is not None else args.transport
    common = dict(
        device=args.device, microbatches=args.microbatches, c1=args.c1,
        c2=args.c2, partition=args.partition, wire_dtype=args.wire_dtype,
        wire_codec=args.wire_codec, weight_cache=not args.no_weight_cache,
        bandwidth_mbps=args.bandwidth_mbps, transport=transport,
        expected_slaves=args.expected_slaves, listen_host=args.listen_host,
        listen_port=args.listen_port, heartbeat_s=args.heartbeat_s,
    )
    try:
        if args.serve:
            rec, _ = run_serve(
                slowdowns, backends, requests=args.requests,
                deadline_s=args.deadline_s, max_batch=args.max_batch,
                image_size=args.image_size, **common,
            )
            ok = rec["all_ok"]
        else:
            rec, _ = run_hetero(
                slowdowns, backends, pipeline=args.pipeline,
                train_pipeline=args.train_pipeline, batch=args.batch,
                steps=args.steps, groups=args.groups,
                group_partition=args.group_partition,
                master_nic_mbps=args.master_nic_mbps, cfg=cfg,
                lr=(vgg16.SGD_LR if isinstance(cfg, ConvChainConfig)
                    else resnet50.SGD_LR if isinstance(cfg, ResNetConfig) else 0.05),
                **common,
            )
            ok = bool(np.isfinite(rec["losses"]).all())
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    except SystemExit:
        raise  # config validation: no cluster yet
    except BaseException:
        traceback.print_exc()
        _clean_exit(1)
    _clean_exit(0 if ok else 1)


if __name__ == "__main__":
    main()
