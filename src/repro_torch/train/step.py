"""Train-step factory of the port: loss + grad + optimizer update, with
gradient accumulation over microbatches, global-norm clipping, and the
remat policy threaded into the model forward.

Counterpart of ``repro/train/step.py``.  Gradients come from
``torch.autograd.grad`` where the JAX package takes ``jax.grad``: on the
card the forward runs K4 and K5 and their backward
``flash_attention_vjp`` and ``ssd_vjp``.  The state is a ``TrainState``
of a Python int step, the param tree and the optimizer state; the step
returns a new one and leaves the old one's tensors as they were.

Under a mesh (``make_train_step(..., mesh=...)``) the state is a tree of
DTensors laid out by ``train_state_axes`` and the rules of
``run.tp_mode``; the forward takes those rules, the gradients are
pinned to the params' layout (``constrain_logical_tree``: a
reduce-scatter, not an all-reduce), and the metrics come back as plain
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.registry import ModelApi, rules_for_mode
from repro_torch.optim.optimizers import make_optimizer, optimizer_state_axes
from repro_torch.optim.schedule import make_schedule
from repro_torch.sharding.partitioning import (
    constrain_logical_tree,
    distribute_tree,
    is_dtensor,
    mesh_context,
    param_sharding_for_tree,
)
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


def train_state_axes(api: ModelApi, run: RunConfig, abstract_params) -> TrainState:
    """Logical-axes tree matching TrainState (for the launchers)."""
    p_axes = api.param_axes()
    return TrainState(
        step=None,
        params=p_axes,
        opt_state=optimizer_state_axes(run.optimizer, p_axes, abstract_params),
    )


def shard_train_state(state: TrainState, api: ModelApi, run: RunConfig, mesh) -> TrainState:
    """``state`` laid out on ``mesh`` by ``train_state_axes`` and the
    rules of ``run.tp_mode``."""
    rules = rules_for_mode(run.tp_mode)
    axes = train_state_axes(api, run, state.params)
    return TrainState(
        state.step,
        distribute_tree(state.params, mesh,
                        param_sharding_for_tree(mesh, axes.params, rules, state.params)),
        distribute_tree(state.opt_state, mesh,
                        param_sharding_for_tree(mesh, axes.opt_state, rules, state.opt_state)))


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def _split_batch(x: torch.Tensor, n: int):
    """n microbatches of rows of x; a DTensor is split within each rank's
    shard, so every microbatch keeps the batch's layout."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor

        local = x.to_local()
        lb = local.shape[0]
        if lb % n:
            raise ValueError(f"a batch shard of {lb} does not split into {n} microbatches")
        parts = local.reshape(n, lb // n, *local.shape[1:])
        return [DTensor.from_local(parts[i], x.device_mesh, x.placements, run_check=False)
                for i in range(n)]
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    parts = x.reshape(n, b // n, *x.shape[1:])
    return [parts[i] for i in range(n)]


def _clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / norm), norm), the norm over every
    leaf in float32.  As in the JAX package, a bf16 gradient times the
    float32 scale comes out float32."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), gnorm


def make_train_step(api: ModelApi, run: RunConfig, *, mesh=None, **fns) -> Callable[
        [TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step for this model and run config.

    ``batch``: {"tokens": (B, S) int, "labels": (B, S) int, + optional
    modality inputs ("patches" / "frames")}, tensors on the params'
    device (DTensors under a ``mesh``).  ``fns`` go to the model's
    forward (``attention_fn``, ``ssd_fn``: K4 and K5 unless given).
    Metrics: ``loss``, ``aux_loss``, ``grad_norm`` (with
    ``run.max_grad_norm``) and ``lr``, 0-d float32 tensors."""
    opt = make_optimizer(run.optimizer, weight_decay=run.weight_decay)
    rules = rules_for_mode(run.tp_mode) if mesh is not None else None
    if mesh is not None:
        fns = dict(fns, rules=rules, mesh=mesh)
    p_axes = api.param_axes()
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
        grads = tree_map(lambda _: next(flat), params)
        if rules is not None:  # the gradient layout pins
            grads = constrain_logical_tree(grads, rules, p_axes)
        return grads, loss.detach(), aux.detach()

    def microbatch_split(batch, n):
        parts = {k: _split_batch(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with mesh_context(mesh):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        n = run.grad_accum
        if n > 1:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32), state.params)
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

        metrics = {"loss": _plain(loss), "aux_loss": _plain(aux)}
        if run.max_grad_norm is not None:
            grads, gnorm = _clip_by_global_norm(grads, run.max_grad_norm)
            metrics["grad_norm"] = _plain(gnorm)
        lr = schedule(state.step)
        metrics["lr"] = torch.tensor(lr, dtype=F32)
        new_params, new_opt = opt.update(grads, state.opt_state, state.params, lr)
        return TrainState(step=state.step + 1, params=new_params, opt_state=new_opt), metrics

    return train_step
