"""Dry run of the port at 256 / 512 GPUs: one train, prefill or decode step
of every (arch x shape x mesh x mode) counted per device under the
three-term H100 roofline, with no device memory and no GPUs but one.

    python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k \
        [--mesh single|multi|both|host] [--tp-mode megatron] [--device cuda|cpu] \
        [--out records.jsonl]

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles the
production program on 512 placeholder host devices and reads the HLO.
Here the production mesh stands on a *fake* process group: one process
is rank 0 of a group of 256 (``single``, (16, 16)) or 512 (``multi``,
(2, 16, 16)) ranks whose collectives move nothing, and every tensor is a
fake one (``FakeTensorMode``: shapes, dtypes, devices, no storage).  A
process has one default group, so this CLI must be its own process and
starts the group before any mesh; ``--mesh both`` runs itself once per
mesh.  The state is built abstractly (``init_train_state``, the decode
cache through ``input_specs``) and laid out on the mesh by the rules of
``--tp-mode`` (``train_state_axes``, ``cache_axes``); the step runs
under ``roofline/op_count.py::OpCounter``, and each record carries the
JAX record's keys (``chips``, ``mesh``, ``flops_per_device``,
``dominant``, ``hbm_bytes_per_device``, ``collective_breakdown``, the
roofline terms).  The >20 B architectures train with adafactor and full
remat (``run_config_for``), as in the JAX package.

``--mesh host`` counts the same step on the (1, 1) mesh of the card
(``launch/mesh.py::make_host_mesh``), fake tensors on ``--device``;
``--global-batch`` and ``--seq-len`` resize the named shape (and
``dryrun_shape`` takes any ``InputShape``), so ``chip_smoke.py`` can
count the exact step it measures.  ``--device cuda`` (the default) puts
the fake tensors on the card's device type; ``cpu`` where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (
    ARCH_IDS,
    INPUT_SHAPES,
    RunConfig,
    get_config,
    input_specs,
    shapes_for_arch,
)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, mesh_name
from repro_torch.models.registry import TP_MODES, build_model, rules_for_mode
from repro_torch.roofline.analysis import report_from_counts
from repro_torch.roofline.op_count import OpCounter
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.sharding.local import distribute_local
from repro_torch.sharding.partitioning import distribute_tree, param_sharding_for_tree
from repro_torch.train.step import init_train_state, make_train_step, shard_train_state

CHIPS = {"single": 256, "multi": 512}


def start_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake default group of ``world_size``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _n_params(cfg: ModelConfig) -> float:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import tree_leaves

    with FakeTensorMode():
        params = build_model(cfg).init(torch.Generator().manual_seed(0), torch.device("cpu"))
    return float(sum(p.numel() for p in tree_leaves(params)))


def run_config_for(cfg: ModelConfig, tp_mode: str, remat: str = "full") -> RunConfig:
    """Per-arch run settings: the >20B archs need the beyond-paper memory
    regime (adafactor + full remat); minicpm trains with WSD."""
    big = _n_params(cfg) > 20e9
    return RunConfig(
        tp_mode=tp_mode,
        optimizer="adafactor" if big else "adam",
        remat=remat,
        schedule="wsd" if cfg.arch_id == "minicpm-2b" else "cosine",
        grad_accum=1,
    )


def _batch_on_mesh(specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The batch's fake tensors sharded on the batch axes the mesh has."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Shard(0) if n in ("pod", "data") else Replicate() for n in mesh.mesh_dim_names)
    return {k: distribute_local(v, mesh, pl) for k, v in specs.items()}


def _counted(fn, *track):
    counter = OpCounter()
    counter.track(*track)
    t0 = time.perf_counter()
    with counter:
        fn()
    return counter, time.perf_counter() - t0


def count_step(cfg: ModelConfig, shape: InputShape, mesh, tp_mode: str, *,
               remat: str = "full", device: str = "cuda"):
    """(OpCounter, seconds) of one ``shape.kind`` step of ``cfg`` on
    ``mesh`` under ``tp_mode``'s rules, every tensor fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    api = build_model(cfg)
    rules = rules_for_mode(tp_mode)
    dev = torch.device(device)
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        specs = input_specs(cfg, shape, fake_mode=fake, device=dev)
        if shape.kind == "train":
            run = run_config_for(cfg, tp_mode, remat)
            state = shard_train_state(init_train_state(
                torch.Generator(device=dev).manual_seed(0), api, run, dev), api, run, mesh)
            batch = _batch_on_mesh(specs, mesh)
            step = make_train_step(api, run, mesh=mesh)
            return _counted(lambda: step(state, batch), state, batch)
        run = RunConfig(tp_mode=tp_mode)
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
        params = distribute_tree(params, mesh, param_sharding_for_tree(
            mesh, api.param_axes(), rules, params))
        if shape.kind == "prefill":
            batch = _batch_on_mesh(specs, mesh)
            step = make_prefill_step(api, run, mesh=mesh)
            return _counted(lambda: step(params, batch), params, batch)
        from repro_torch.models.transformer import shard_cache

        cache = shard_cache(specs["cache"], api.cache_axes(), rules, mesh)
        tokens = _batch_on_mesh({"tokens": specs["tokens"]}, mesh)["tokens"]
        step = make_serve_step(api, run, mesh=mesh)
        return _counted(lambda: step(params, cache, tokens), params, cache, tokens)


def dryrun_shape(arch: str, shape: InputShape, mesh, *, tp_mode: str = "megatron",
                 remat: str = "full", moe_dispatch: Optional[str] = None,
                 device: str = "cuda", verbose: bool = True) -> dict:
    """Count one (arch x shape) step on ``mesh``; return the record."""
    cfg = get_config(arch)
    if moe_dispatch and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    counter, seconds = count_step(cfg, shape, mesh, tp_mode, remat=remat, device=device)
    chips = mesh.size()
    report = report_from_counts(counter, cfg=cfg, shape=shape, mesh_name=mesh_name(mesh),
                                tp_mode=tp_mode, chips=chips)
    rec = report.to_dict()
    rec["remat"] = remat
    rec["moe_dispatch"] = moe_dispatch or (cfg.moe.dispatch if cfg.moe else None)
    rec["compile_s"] = seconds  # the counted step's host seconds (nothing compiles)
    rec["ops"] = counter.ops
    args = counter.argument_bytes
    rec["memory_analysis"] = {
        "argument_size_in_bytes": int(args),
        "temp_size_in_bytes": int(counter.peak_bytes - args),
    }
    rec["hbm_bytes_per_device"] = int(counter.peak_bytes)
    if verbose:
        print(report.row(), f"hbm/dev={counter.peak_bytes / 1e9:7.2f}GB "
              f"count={seconds:6.1f}s", flush=True)
    return rec


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               tp_mode: str = "megatron", remat: str = "full",
               moe_dispatch: Optional[str] = None, device: str = "cuda",
               verbose: bool = True) -> dict:
    """One (arch x shape x mode) on the production mesh of this process's
    fake group."""
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    return dryrun_shape(arch, INPUT_SHAPES[shape_name], mesh, tp_mode=tp_mode, remat=remat,
                        moe_dispatch=moe_dispatch, device=device, verbose=verbose)


def main(argv=None):
    """The command line (see the module docstring)."""
    ap = argparse.ArgumentParser(description="multi-pod dry run of the port")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "host"])
    ap.add_argument("--tp-mode", default="megatron", choices=list(TP_MODES) + ["both"])
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--moe-dispatch", default=None, choices=["psum", "alltoall"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (cuda by default)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="resize the (single) --shape to this batch")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="resize the (single) --shape to this sequence length")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default) needs a CUDA card and "
                         "torch.cuda.is_available() is False; pass --device cpu")
    if args.mesh == "both":  # one default group per process: one process per mesh
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--mesh") if "--mesh" in argv else None
        rc = 0
        for kind in ("single", "multi"):
            sub = (argv[:i] + argv[i + 2:] if i is not None else argv) + ["--mesh", kind]
            rc |= subprocess.call([sys.executable, "-m", "repro_torch.launch.dryrun", *sub])
        raise SystemExit(rc)

    if args.mesh == "host":
        mesh = make_host_mesh(args.device)
    else:
        start_fake_group(CHIPS[args.mesh])
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", device_type=args.device)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    modes = ["megatron", "gather"] if args.tp_mode == "both" else [args.tp_mode]
    n_ok = n_fail = 0
    for arch in archs:
        allowed = shapes_for_arch(get_config(arch))
        shapes = allowed if args.shape == "all" else (
            [args.shape] if args.shape in allowed else [])
        for shape_name in shapes:
            shape = INPUT_SHAPES[shape_name]
            if args.global_batch or args.seq_len:
                b = args.global_batch or shape.global_batch
                s = args.seq_len or shape.seq_len
                shape = InputShape(f"{shape.kind}_b{b}_s{s}", s, b, shape.kind)
            for mode in modes:
                try:
                    rec = dryrun_shape(arch, shape, mesh, tp_mode=mode,
                                       remat=args.remat, moe_dispatch=args.moe_dispatch,
                                       device=args.device)
                    n_ok += 1
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(rec) + "\n")
                except Exception:
                    n_fail += 1
                    print(f"FAIL {arch} {shape_name} {args.mesh} {mode}")
                    traceback.print_exc()
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    dist.destroy_process_group()
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
