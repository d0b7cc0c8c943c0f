"""Eight gloo ranks on a (2, 4) ("data", "model") mesh, for
tests/test_torch_mesh.py and tests/test_torch_moe_sharded.py: each case
of the input file runs sharded on every rank, and rank 0 writes the
results (full tensors, as numpy) to the output file.

    python tests/_torch_mesh_worker.py {lm|moe} IN.pkl OUT.pkl PORT

Imports no jax: the test process computes the JAX and unsharded
results and compares.
"""
import os
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

WORLD = 8


def _np(t):
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _lm_case(case, mode, mesh):
    from repro_torch import convert
    from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.models.registry import build_model, rules_for_mode
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    from repro_torch.sharding.partitioning import (
        distribute_tree,
        mesh_context,
        param_sharding_for_tree,
    )
    from repro_torch.sharding.partitioning import is_dtensor
    from repro_torch.train.step import TrainState, make_train_step, train_state_axes
    from repro_torch.tree import tree_map

    cfg = reduced_for_smoke(get_config(case["arch"]))
    api = build_model(cfg)
    rules = rules_for_mode(mode)
    from_np = (convert.encdec_params_from_numpy if cfg.num_encoder_layers
               else convert.lm_params_from_numpy)
    params = from_np(case["params"], cfg, "cpu")
    dparams = distribute_tree(params, mesh, param_sharding_for_tree(
        mesh, api.param_axes(), rules, params))
    out = {}
    batch = make_global_batch(case["batch"], mesh)
    with mesh_context(mesh):
        logits, _ = api.forward(dparams, batch, rules=rules, mesh=mesh)
    out["forward"] = _np(logits)

    run = RunConfig(tp_mode=mode)
    s = case["prompt_len"]
    prompt = {k: (v[:, :s] if k == "tokens" else v) for k, v in case["batch"].items()}
    logits, cache = make_prefill_step(api, run, mesh=mesh, cache_len=case["cache_len"])(
        dparams, make_global_batch(prompt, mesh))
    out["prefill"] = _np(logits)
    out["cache_placements"] = {
        k: [f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__ for p in v.placements]
        for k, v in cache.items() if is_dtensor(v)}
    ptrs = {k: v.to_local().data_ptr() for k, v in cache.items() if is_dtensor(v)}
    step = make_serve_step(api, run, mesh=mesh)
    toks = torch.from_numpy(case["batch"]["tokens"])
    out["decode"] = []
    from repro_torch.roofline.op_count import OpCounter

    for t in range(s, s + case["decode_steps"]):
        with OpCounter() as counter:
            _, logits, cache = step(dparams, cache, toks[:, t:t + 1])
        out["decode"].append(_np(logits))
    out["decode_collective_bytes"] = counter.collective_bytes  # the last step's
    # the same step against a cache of twice the slots
    _, cache2 = make_prefill_step(api, run, mesh=mesh, cache_len=2 * case["cache_len"])(
        dparams, make_global_batch(prompt, mesh))
    with OpCounter() as counter:
        step(dparams, cache2, toks[:, s:s + 1])
    out["decode_collective_bytes_2x_cache"] = counter.collective_bytes
    # the cache is written in place, in each rank's own shards
    out["cache_in_place"] = all(cache[k].to_local().data_ptr() == p for k, p in ptrs.items())
    out["cache_after"] = {k: _np(v) for k, v in cache.items() if is_dtensor(v)}

    trun = RunConfig(tp_mode=mode, optimizer="sgd", learning_rate=case["lr"],
                     warmup_steps=1, total_steps=10, remat="none")
    axes = train_state_axes(api, trun, params)
    from repro_torch.optim.optimizers import make_optimizer

    opt_state = make_optimizer("sgd").init(params)
    state = TrainState(0, dparams, distribute_tree(opt_state, mesh, param_sharding_for_tree(
        mesh, axes.opt_state, rules, opt_state)))
    state, metrics = make_train_step(api, trun, mesh=mesh)(
        state, make_global_batch(case["train_batch"], mesh))
    out["train"] = {k: float(v) for k, v in metrics.items()}
    to_np = (convert.encdec_params_to_numpy if cfg.num_encoder_layers
             else convert.lm_params_to_numpy)
    full = tree_map(lambda p: p.full_tensor() if is_dtensor(p) else p, state.params)
    out["train_params"] = to_np(full, cfg)
    return out


def _cnn_case(case, mode, mesh):
    """One SGD step of the paper's CNN through ``core/conv_shard.py``'s
    kernel-sharded conv (``launch/dryrun_cnn.py::make_cnn_train_step``)."""
    from repro_torch.launch.dryrun_cnn import make_cnn_train_step, place_cnn_inputs
    from repro_torch.models.cnn import make_cnn_config
    from repro_torch.models.registry import rules_for_mode

    cfg = make_cnn_config(*case["sizes"])
    rules = rules_for_mode(mode)
    params = {l: {n: torch.from_numpy(a) for n, a in d.items()}
              for l, d in case["params"].items()}
    p, x, y = place_cnn_inputs(params, torch.from_numpy(case["images"]),
                               torch.from_numpy(case["labels"]), mesh, rules)
    new, loss, _ = make_cnn_train_step(cfg, rules, mesh, lr=case["lr"])(p, x, y)
    return {"loss": float(loss.full_tensor()),
            "params": {l: {n: _np(t) for n, t in d.items()} for l, d in new.items()},
            "conv2_placements": [type(q).__name__ for q in p["conv2"]["kernel"].placements]}


def _moe_case(case, mesh):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.layers.moe import apply_moe
    from repro_torch.sharding.partitioning import mesh_context
    from repro_torch.sharding.local import distribute_local
    from torch.distributed.tensor import Replicate, Shard

    cfg = ModelConfig(arch_id="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                      num_kv_heads=2, d_ff=case["d_ff"], vocab_size=16,
                      moe=MoEConfig(**case["moe"]), dtype="float32", param_dtype="float32")
    params = {"router": {"kernel": torch.from_numpy(case["params"]["router"]["kernel"])},
              **{k: torch.from_numpy(case["params"][k]) for k in ("w_in", "w_gate", "w_out")}}
    x = distribute_local(torch.from_numpy(case["x"]), mesh, (Shard(0), Replicate()))
    with mesh_context(mesh):
        got, aux = apply_moe(params, x, cfg=cfg, mesh=mesh, token_axes=("data",))
    return {"out": _np(got), "aux": float(aux.full_tensor())}


def _rank(rank, kind, inp, outp, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, case in cases.items():
        if kind == "lm":
            for mode in case["modes"]:
                run = _cnn_case if case.get("kind") == "cnn" else _lm_case
                results[(name, mode)] = run(case, mode, mesh)
        else:
            results[name] = _moe_case(case, mesh)
    if rank == 0:
        with open(outp, "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    kind, inp, outp, port = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
    mp.spawn(_rank, args=(kind, inp, outp, port), nprocs=WORLD, join=True)
