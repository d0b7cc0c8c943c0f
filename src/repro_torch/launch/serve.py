"""Serving launcher of the port: batched prefill + greedy/sampled decode
of a model-zoo architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --batch 4 --prompt-len 32 --max-new 16 [--device cpu]

Counterpart of ``repro/launch/serve.py``, for every family: a VLM's
prompt carries random patch embeddings in its first positions, and the
encoder-decoder's batch random frame embeddings (``make_batch``).
Without ``--full`` the architecture is reduced for a smoke run
(``reduced_for_smoke``: 2 layers, d_model <= 256, float32); ``--full``
serves the published config on one card, in its own dtype.  ``--device`` is ``cuda`` (the
default: the hand-written kernels K4 and K5 run the prefill) or ``cpu``
(their plain versions); ``cuda`` without a card is an error, never a CPU
fallback.

The command line always serves under a mesh: the (1, 1) mesh of
``--device`` (``launch/mesh.py::make_host_mesh``), the params laid out
by the model's ``param_axes`` and the rules of ``--tp-mode`` (megatron
or gather), through ``ServeEngine(mesh=...)``.  ``load()`` takes that
mesh as an argument and without one serves plain tensors on one device.
The production meshes are reached only by the dry run; a real
multi-GPU process group is not part of this launcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
from repro_torch.launch.mesh import host_mesh
from repro_torch.models.registry import build_model, rules_for_mode
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding.partitioning import distribute_tree, param_sharding_for_tree


def make_batch(cfg, *, seed: int, batch: int, prompt_len: int, device) -> dict:
    """A prompt batch from numpy's generator seeded with ``seed``, drawn
    in the JAX launcher's order: random ``tokens`` (B, prompt_len), then
    for a VLM ``patches`` (B, num_image_tokens, vision_dim) and for the
    encoder-decoder ``frames`` (B, num_frames, frame_dim), both standard
    normal float32."""
    rng = np.random.default_rng(seed)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))}
    if cfg.vision is not None:
        v = cfg.vision
        inputs["patches"] = rng.normal(size=(batch, v.num_image_tokens, v.vision_dim))
    if cfg.audio is not None:
        a = cfg.audio
        inputs["frames"] = rng.normal(size=(batch, a.num_frames, a.frame_dim))
    return {k: torch.from_numpy(a if k == "tokens" else a.astype(np.float32)).to(device)
            for k, a in inputs.items()}


def load(arch: str, *, full: bool, seed: int, batch: int, prompt_len: int, device,
         mesh=None, tp_mode: str = "megatron"):
    """The engine over ``arch``'s params (the model's ``init`` from a
    generator seeded with ``seed`` on ``device``; with a ``mesh``, laid
    out on it by ``tp_mode``'s rules) and a prompt batch
    (``make_batch``)."""
    cfg = get_config(arch)
    if not full:
        cfg = reduced_for_smoke(cfg)
    api = build_model(cfg)
    device = torch.device(device)
    params = api.init(torch.Generator(device=device).manual_seed(seed), device)
    inputs = make_batch(cfg, seed=seed, batch=batch, prompt_len=prompt_len, device=device)
    if mesh is None:
        return ServeEngine(api=api, params=params), inputs
    rules = rules_for_mode(tp_mode)
    params = distribute_tree(params, mesh, param_sharding_for_tree(
        mesh, api.param_axes(), rules, params))
    return ServeEngine(api=api, params=params, mesh=mesh,
                       run=RunConfig(tp_mode=tp_mode)), inputs


def main(argv=None):
    """The command line: parse the flags, refuse ``--device cuda`` without
    a card, serve under the host mesh of ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--full", action="store_true",
                    help="the published config on one card (default: reduced)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp-mode", default="megatron", choices=["megatron", "gather"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default) needs a CUDA card and "
            "torch.cuda.is_available() is False; pass --device cpu to run "
            "the plain PyTorch versions of the kernels on the CPU"
        )
    with host_mesh(args.device) as mesh:
        engine, batch = load(args.arch, full=args.full, seed=args.seed, batch=args.batch,
                             prompt_len=args.prompt_len, device=args.device, mesh=mesh,
                             tp_mode=args.tp_mode)
        timings = {}
        t0 = time.perf_counter()
        out = engine.generate(batch, max_new_tokens=args.max_new, sample=args.sample,
                              temperature=args.temperature, seed=args.seed,
                              timings=timings)
        dt = time.perf_counter() - t0
        toks = args.batch * args.max_new
        steps = max(timings["decode_steps"], 1)
        print(f"generated {tuple(out.shape)} in {dt:.2f}s ({toks / dt:.1f} tok/s): "
              f"prefill {timings['prefill_s']:.3f}s, decode "
              f"{timings['decode_s'] / steps * 1e3:.2f} ms/token on {args.device}")
        print(out[:2].cpu().numpy())


if __name__ == "__main__":
    main()
