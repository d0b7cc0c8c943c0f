"""The paper's OWN architecture on the production mesh: the CIFAR-10 CNN
with kernel-sharded convolutions (``core/conv_shard.py``), one SGD step
counted per device at batch 1024 (the paper's largest), the faithful
gather schedule against the channel-sharded (beyond-paper) one.

    python -m repro_torch.launch.dryrun_cnn [--batch 1024] [--device cuda|cpu] \
        [--out records.jsonl]

Counterpart of ``repro/launch/dryrun_cnn.py``: the (16, 16) mesh stands
on a fake process group of 256 ranks (``launch/dryrun.py``), every
tensor is fake, and the step runs under ``roofline/op_count.py``'s
counter.  ``make_cnn_train_step`` is the step itself, on any mesh and
real tensors too: ``chip_smoke.py`` runs it on the card's (1, 1) mesh.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs.cifar_cnn import CONFIGS
from repro_torch.core.conv_shard import make_sharded_conv
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models.cnn import cnn_axes, cnn_loss, init_cnn
from repro_torch.models.registry import rules_for_mode
from repro_torch.roofline.analysis import HW
from repro_torch.roofline.op_count import OpCounter
from repro_torch.sharding.local import distribute_local
from repro_torch.sharding.partitioning import (
    distribute_tree,
    mesh_context,
    param_sharding_for_tree,
)
from repro_torch.tree import tree_leaves, tree_map


def make_cnn_train_step(cfg, rules, mesh, lr: float = 0.05):
    """train_step(params, images, labels) -> (new params, loss, acc): one
    SGD step of ``cnn_loss`` with the kernel-sharded conv, under ``mesh``."""
    conv_fn = make_sharded_conv(rules)

    def train_step(params, images, labels):
        with mesh_context(mesh):
            params = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, acc = cnn_loss(params, images, labels, cfg=cfg, conv_fn=conv_fn)
            leaves = tree_leaves(params)
            grads = iter(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                new = tree_map(lambda p: p - lr * next(grads), params)
        return new, loss.detach(), acc

    return train_step


def place_cnn_inputs(params, images, labels, mesh, rules):
    """Params laid out by ``cnn_axes`` and the batch sharded on the batch
    axes of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    params = distribute_tree(params, mesh,
                             param_sharding_for_tree(mesh, cnn_axes(), rules, params))
    pl = tuple(Shard(0) if n in ("pod", "data") else Replicate() for n in mesh.mesh_dim_names)
    return params, distribute_local(images, mesh, pl), distribute_local(labels, mesh, pl)


def dryrun_cnn(arch: str, batch: int, tp_mode: str, multi_pod: bool = False,
               device: str = "cuda") -> dict:
    """Count one train step of ``arch`` at ``batch`` on the production
    mesh of this process's fake group; return the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = CONFIGS[arch]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    rules = rules_for_mode(tp_mode)
    dev = torch.device(device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = init_cnn(torch.Generator().manual_seed(0), cfg, dev)
        images = torch.empty((batch, 32, 32, 3), dtype=torch.float32, device=dev)
        labels = torch.empty((batch,), dtype=torch.int64, device=dev)
        params, images, labels = place_cnn_inputs(params, images, labels, mesh, rules)
        step = make_cnn_train_step(cfg, rules, mesh)
        counter = OpCounter()
        counter.track(params, images, labels)
        t0 = time.perf_counter()
        with counter:
            step(params, images, labels)
        seconds = time.perf_counter() - t0
    chips = mesh.size()
    rec = {
        "arch_id": arch, "shape": f"train_b{batch}", "mesh": mesh_name(mesh),
        "tp_mode": tp_mode, "chips": chips,
        "flops_per_device": counter.flops,
        "compute_s": counter.flops / HW.peak_flops,
        "memory_s": counter.memory_bytes / HW.hbm_bw,
        "collective_s": counter.collective_bytes / HW.link_bw,
        "collective_breakdown": dict(counter.by_kind),
        "hbm_bytes_per_device": int(counter.peak_bytes),
        "count_s": seconds,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: rec[k])
    rec["dominant"] = dom.split("_")[0]
    print(
        f"{arch:22s} b={batch:5d} {tp_mode:9s} "
        f"C={rec['compute_s']:.2e} M={rec['memory_s']:.2e} "
        f"X={rec['collective_s']:.2e} dom={rec['dominant']:10s} "
        f"hbm/dev={counter.peak_bytes / 2 ** 20:8.1f}MiB", flush=True,
    )
    return rec


def main(argv=None):
    """The command line: every CNN size (or ``--arch``), gather then
    megatron, on the fake (16, 16) group."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--arch", default="all", help="a cifar_cnn config or 'all'")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (cuda by default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default) needs a CUDA card and "
                         "torch.cuda.is_available() is False; pass --device cpu")
    from repro_torch.launch.dryrun import start_fake_group

    start_fake_group(256)
    archs = list(CONFIGS) if args.arch == "all" else [args.arch]
    recs = [dryrun_cnn(arch, args.batch, mode, device=args.device)
            for arch in archs for mode in ("gather", "megatron")]
    if args.out:
        with open(args.out, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
