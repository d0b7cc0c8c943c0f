"""End-to-end driver on the PyTorch port: train a ~100M-parameter
decoder-only LM for a few hundred steps on the synthetic bigram task,
with checkpointing and eval — the (b) deliverable's training end of the
spectrum.

The config is a scaled-down yi-style dense transformer (~100M params).
On ``--device cuda`` (the default) every attention of the forward is the
hand-written flash-attention kernel (K4) and its backward
``flash_attention_vjp``; on ``--device cpu`` the kernel's plain version.
The checkpoint is written in the JAX package's layout and format
(``repro.checkpoint.io.restore_checkpoint`` reads it), and read back
through the port's ``checkpoint/io.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--device cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data.pipeline import synthetic_token_batches
from repro_torch.models.registry import build_model
from repro_torch.train.loss import softmax_cross_entropy
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

LM_100M = ModelConfig(
    arch_id="lm-100m", family="dense", num_layers=12, d_model=640,
    num_heads=10, num_kv_heads=5, d_ff=2560, vocab_size=8192,
    head_dim=64, dtype="float32", param_dtype="float32",
    source="scaled-down yi-6b [arXiv:2403.04652]",
)


def main(argv=None):
    """Train, save, restore, evaluate; returns the run's numbers (s/step,
    tok/s, the first and last train loss, each logged eval and the
    restored checkpoint's eval loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm100m"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the hand-written kernels; the default) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --device cuda (the default) needs a CUDA "
                         "card; pass --device cpu to run on the CPU")
    device = torch.device(args.device)

    cfg = LM_100M
    api = build_model(cfg)
    run = RunConfig(
        optimizer="adam", learning_rate=args.lr, schedule="cosine",
        warmup_steps=args.steps // 20, total_steps=args.steps,
        remat="none", grad_accum=1, tp_mode="megatron",
    )
    state = init_train_state(torch.Generator(device=device).manual_seed(0), api, run,
                             device)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"{cfg.arch_id}: {n_params/1e6:.1f}M params")
    step = make_train_step(api, run)

    train_it = synthetic_token_batches(args.batch, args.seq, cfg.vocab_size, seed=0)
    # held-out samples from the SAME task (same bigram permutation)
    eval_it = synthetic_token_batches(
        args.batch, args.seq, cfg.vocab_size, seed=0, stream_seed=999
    )

    def on_device(host):
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    @torch.inference_mode()
    def eval_loss(params, batch):
        logits, _ = api.forward(params, batch)
        return float(softmax_cross_entropy(logits, batch["labels"]))

    t0 = time.time()
    tokens_seen = 0
    first_loss = None
    losses, evals = [], []
    for i in range(args.steps):
        state, m = step(state, on_device(next(train_it)))
        tokens_seen += args.batch * args.seq
        if i % 25 == 0 or i == args.steps - 1:
            ev = eval_loss(state.params, on_device(next(eval_it)))
            loss = float(m["loss"])
            first_loss = first_loss if first_loss is not None else loss
            losses.append(loss)
            evals.append(ev)
            tps = tokens_seen / (time.time() - t0)
            print(
                f"step {i:4d} train={loss:.3f} eval={ev:.3f} "
                f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                f"({tps:,.0f} tok/s)", flush=True,
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0
    path = save_checkpoint(args.ckpt_dir, args.steps, lm_params_to_numpy(state.params, cfg))
    print(f"checkpoint -> {path}")

    restored = lm_params_from_numpy(restore_checkpoint(args.ckpt_dir, device=device), cfg,
                                    device)
    ev = eval_loss(restored, on_device(next(eval_it)))
    print(f"restored-checkpoint eval loss {ev:.3f}")
    assert ev < first_loss - 1.0, "model did not learn"
    print("OK: loss dropped by "
          f"{first_loss - ev:.2f} nats over {args.steps} steps.")
    return {"device": args.device, "arch": cfg.arch_id, "params_m": n_params / 1e6,
            "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "s_per_step": train_s / args.steps, "tokens_per_s": tokens_seen / train_s,
            "first_loss": first_loss, "last_loss": losses[-1], "logged_losses": losses,
            "logged_evals": evals, "restored_eval_loss": ev, "checkpoint": path}


if __name__ == "__main__":
    main()
