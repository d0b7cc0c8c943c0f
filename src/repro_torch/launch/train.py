"""Training launcher of the port: real optimization steps on the
synthetic token stream, for any model-zoo architecture.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 50 [--device cpu]

Counterpart of ``repro/launch/train.py``.  Without ``--full`` it trains
the smoke-scale variant of the architecture (``reduced_for_smoke``: 2
layers, d_model <= 256, float32); ``--full`` trains the published config
on one card, in its own dtype, with every block rematerialised
(``remat="full"``), as the JAX launcher's ``--full`` does on its mesh.
The schedule is ``wsd`` for minicpm-2b and ``cosine`` otherwise.  A VLM's
batch carries random patch embeddings and the encoder-decoder's random
frame embeddings (``add_modalities``).  ``--device`` is ``cuda`` (the
default: K4 and K5 run every forward, ``flash_attention_vjp`` and
``ssd_vjp`` their backward) or ``cpu`` (the kernels' plain versions);
``cuda`` without a card is an error, never a CPU fallback.  With
``--ckpt-dir`` the final params are saved in the JAX package's layout
and format.

The command line always trains under a mesh, as the JAX launcher does:
the (1, 1) mesh of ``--device`` (``launch/mesh.py::make_host_mesh``),
the state laid out by ``train_state_axes`` and the rules of
``--tp-mode`` (megatron or gather), each batch put on the mesh by
``make_global_batch``.  ``train()`` takes that mesh as an argument and
without one trains on the plain tensors of one device.  The production
meshes of 256 and 512 devices are reached only by the dry run
(``launch/dryrun.py``); a real multi-GPU process group is not part of
this launcher.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
from repro_torch.convert import encdec_params_to_numpy, lm_params_to_numpy
from repro_torch.data.pipeline import make_global_batch, synthetic_token_batches
from repro_torch.launch.mesh import host_mesh
from repro_torch.models.registry import build_model
from repro_torch.sharding.partitioning import is_dtensor
from repro_torch.train.step import init_train_state, make_train_step, shard_train_state
from repro_torch.tree import tree_map


def add_modalities(batch, cfg, rng):
    """The JAX launcher's modality inputs, drawn from ``rng`` after the
    tokens: ``patches`` (B, num_image_tokens, vision_dim) for a VLM,
    ``frames`` (B, num_frames, frame_dim) for the encoder-decoder,
    standard normal float32."""
    if cfg.vision is not None:
        v = cfg.vision
        batch["patches"] = rng.normal(
            size=(batch["tokens"].shape[0], v.num_image_tokens, v.vision_dim)
        ).astype(np.float32)
    if cfg.audio is not None:
        a = cfg.audio
        batch["frames"] = rng.normal(
            size=(batch["tokens"].shape[0], a.num_frames, a.frame_dim)
        ).astype(np.float32)
    return batch


def train(arch: str, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          optimizer: str = "adam", grad_accum: int = 1, full: bool = False,
          seed: int = 0, device="cuda", ckpt_dir: Optional[str] = None,
          log_every: int = 10, log: Callable[[str], None] = print,
          tp_mode: str = "megatron", mesh=None):
    """Train ``arch`` for ``steps`` steps of ``batch`` sequences of
    ``seq`` tokens on ``device``: params from a generator seeded with
    ``seed`` on the device, batches from ``synthetic_token_batches`` and
    numpy's generator seeded with ``seed``; the JAX launcher's run
    config (``wsd`` for minicpm-2b, else ``cosine``; warmup a tenth of
    the steps; remat ``full`` with ``full``).  Returns (the final ``TrainState``, one record per step:
    ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` as floats and
    ``elapsed_s``, host seconds from the first step's start to this
    step's metrics on the host).  With a ``mesh`` the state and batches
    are laid out on it by ``tp_mode``'s rules."""
    cfg = get_config(arch)
    if not full:
        cfg = reduced_for_smoke(cfg)
    api = build_model(cfg)
    run = RunConfig(
        optimizer=optimizer,
        learning_rate=lr,
        grad_accum=grad_accum,
        schedule="wsd" if arch == "minicpm-2b" else "cosine",
        total_steps=steps,
        warmup_steps=max(1, steps // 10),
        remat="full" if full else "none",
        tp_mode=tp_mode,
    )
    device = torch.device(device)
    state = init_train_state(torch.Generator(device=device).manual_seed(seed), api, run,
                             device)
    if mesh is not None:
        state = shard_train_state(state, api, run, mesh)
    step_fn = make_train_step(api, run, mesh=mesh)
    it = synthetic_token_batches(batch, seq, cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed)
    records: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for i in range(steps):
        host = add_modalities(next(it), cfg, rng)
        if mesh is None:
            inputs = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        else:
            inputs = make_global_batch(host, mesh, device=device)
        state, metrics = step_fn(state, inputs)
        rec = {k: float(v) for k, v in metrics.items()}
        rec["elapsed_s"] = time.perf_counter() - t0
        records.append(rec)
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:5d} loss={rec['loss']:.4f} aux={rec['aux_loss']:.4f} "
                f"lr={rec['lr']:.2e} ({rec['elapsed_s']:.1f}s)")
    if ckpt_dir:
        to_numpy = encdec_params_to_numpy if cfg.num_encoder_layers else lm_params_to_numpy
        params = tree_map(lambda p: p.full_tensor() if is_dtensor(p) else p, state.params)
        path = save_checkpoint(ckpt_dir, steps, to_numpy(params, cfg))
        log(f"saved params to {path}")
    return state, records


def main(argv=None):
    """The command line: parse the flags, refuse ``--device cuda``
    without a card, train under the host mesh of ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam", choices=["sgd", "adam", "adafactor"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="the published config on one card (default: reduced)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
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
        train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
              optimizer=args.optimizer, grad_accum=args.grad_accum, full=args.full,
              seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir,
              log_every=args.log_every, log=lambda line: print(line, flush=True),
              tp_mode=args.tp_mode, mesh=mesh)


if __name__ == "__main__":
    main()
