"""Train-step factory of the port: loss + grad + optimizer update, with
gradient accumulation over microbatches, global-norm clipping, and the
remat policy threaded into the model forward.

Counterpart of ``repro/train/step.py``.  Gradients come from
``torch.autograd.grad`` where the JAX package takes ``jax.grad``: on the
card the forward runs K4 and K5 and their backward
``flash_attention_vjp`` and ``ssd_vjp``.  The state is a ``TrainState``
of a Python int step, the param tree and the optimizer state; the step
returns a new one and leaves the old one's tensors as they were.  The
logical-axes tree (``train_state_axes``) and the gradient layout pins
come with the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.registry import ModelApi
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedule import make_schedule
from repro_torch.train.loss import softmax_cross_entropy
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass
class TrainState:
    """The steps taken, the param tree and the optimizer state."""

    step: int
    params: Any
    opt_state: Any


def init_train_state(generator: torch.Generator, api: ModelApi, run: RunConfig,
                     device) -> TrainState:
    """Params drawn from ``generator`` on ``device``, the optimizer's
    zero state, step 0."""
    params = api.init(generator, torch.device(device))
    opt = make_optimizer(run.optimizer, weight_decay=run.weight_decay)
    return TrainState(step=0, params=params, opt_state=opt.init(params))


def _clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / norm), norm), the norm over every
    leaf in float32.  As in the JAX package, a bf16 gradient times the
    float32 scale comes out float32."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), gnorm


def make_train_step(api: ModelApi, run: RunConfig, **fns) -> Callable[
        [TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step for this model and run config.

    ``batch``: {"tokens": (B, S) int, "labels": (B, S) int, + optional
    modality inputs ("patches" / "frames")}, tensors on the params'
    device.  ``fns`` go to the model's forward (``attention_fn``,
    ``ssd_fn``: K4 and K5 unless given).  Metrics: ``loss``,
    ``aux_loss``, ``grad_norm`` (with ``run.max_grad_norm``) and ``lr``,
    0-d float32 tensors."""
    opt = make_optimizer(run.optimizer, weight_decay=run.weight_decay)
    schedule = make_schedule(
        run.schedule,
        learning_rate=run.learning_rate,
        warmup_steps=run.warmup_steps,
        total_steps=run.total_steps,
    )

    def grads_of(params, micro):
        """(grads in the params' dtypes, loss, aux) of one microbatch."""
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(params)
        logits, aux = api.forward(params, micro, remat=run.remat, **fns)
        loss = softmax_cross_entropy(logits, micro["labels"])
        del logits
        gs = torch.autograd.grad(loss + aux, leaves, allow_unused=True)
        flat = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)])
        return tree_map(lambda _: next(flat), params), loss.detach(), aux.detach()

    def microbatch_split(batch, n):
        def split(x):
            b = x.shape[0]
            if b % n:
                raise ValueError(f"batch {b} does not split into {n} microbatches")
            return x.reshape(n, b // n, *x.shape[1:])
        parts = {k: split(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        n = run.grad_accum
        if n > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                             state.params)
            dev = tree_leaves(state.params)[0].device
            loss = torch.zeros((), dtype=F32, device=dev)
            aux = torch.zeros((), dtype=F32, device=dev)
            for micro in microbatch_split(batch, n):
                g, l, a = grads_of(state.params, micro)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                del g
                loss, aux = loss + l, aux + a
            inv = 1.0 / n
            grads = tree_map(lambda g: g * inv, grads)
            loss, aux = loss * inv, aux * inv
        else:
            grads, loss, aux = grads_of(state.params, batch)

        metrics = {"loss": loss, "aux_loss": aux}
        if run.max_grad_norm is not None:
            grads, gnorm = _clip_by_global_norm(grads, run.max_grad_norm)
            metrics["grad_norm"] = gnorm
        lr = schedule(state.step)
        metrics["lr"] = torch.tensor(lr, dtype=F32)
        new_params, new_opt = opt.update(grads, state.opt_state, state.params, lr)
        return TrainState(step=state.step + 1, params=new_params, opt_state=new_opt), metrics

    return train_step
