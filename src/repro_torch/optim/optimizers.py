"""Optimizers of the port: SGD (+momentum), Adam(W), and Adafactor.

Counterpart of ``repro/optim/optimizers.py``, with its interface
(``init(params)`` and ``update(grads, state, params, lr) -> (params,
state)``, pure functions that return new trees) and its semantics:
moments in float32, params updated in float32 and cast back to their
own dtype (bf16 for the published configs), the step count kept.

SGD's and Adam's states mirror the port's param tree (per-layer
lists).  Adafactor's does not: it factors, and clips its update by RMS,
per leaf of the JAX package's tree, where a ``blocks`` leaf stacks every
layer on a leading axis.  So its state is in the JAX package's layout
(one stacked entry per JAX leaf), and its update stacks a layer list's
gradients and params into the JAX leaf, steps it as the JAX package
does, and hands each layer its slice: the factoring decision is made on
the stacked shape and the clip reduces over all layers at once.
``optimizer_state_axes`` gives the state's logical axes in the same
layouts (the JAX package's per stacked leaf for Adafactor), with the
params' ``fsdp_embed`` axis renamed ``opt_embed`` as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import (
    is_layered,
    jax_leaf_groups,
    nested_get,
    nested_set,
    tree_map,
    tree_set,
)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A pair of pure functions: ``init(params) -> state`` and
    ``update(grads, state, params, lr) -> (new_params, new_state)``."""

    init: Callable[[Any], Any]
    # update(grads, state, params, lr) -> (new_params, new_state)
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]


def _zeros_like(params):
    """float32 zeros of each param's shape (and, for a DTensor, layout)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def _count_scale(count: int, beta: float) -> torch.Tensor:
    """1 / (1 - beta ** count) in float32, as the JAX package computes it."""
    c = torch.tensor(float(count), dtype=F32)
    return 1.0 / (1 - beta ** c)


def sgd(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum (state ``mu``, float32) and
    decoupled weight decay."""
    def init(params):
        if momentum:
            return {"mu": _zeros_like(params)}
        return {}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(F32), state["mu"], grads)
            step_dir, new_state = mu, {"mu": mu}
        else:
            step_dir, new_state = tree_map(lambda g: g.to(F32), grads), {}
        new_params = tree_map(
            lambda p, d: (p.to(F32) - lr * (d + weight_decay * p.to(F32))).to(p.dtype),
            params, step_dir)
        return new_params, new_state

    return Optimizer(init, update)


def adam(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adam(W): float32 moments ``mu`` and ``nu``, bias-corrected by the
    step ``count``, and decoupled weight decay."""

    def init(params):
        return {"mu": _zeros_like(params), "nu": _zeros_like(params), "count": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(F32)),
                      state["nu"], grads)
        mu_hat_scale = _count_scale(count, b1)
        nu_hat_scale = _count_scale(count, b2)

        def step(p, m, v):
            upd = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
            return (p.to(F32) - lr * (upd + weight_decay * p.to(F32))).to(p.dtype)

        new_params = tree_map(step, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


def adafactor(
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    min_dim_size_to_factor: int = 128,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adafactor (Shazeer & Stern, 2018) without first moment (factored
    second moments only), per JAX leaf: see the module docstring."""

    def _factored(shape) -> bool:
        return (
            len(shape) >= 2
            and shape[-1] >= min_dim_size_to_factor
            and shape[-2] >= min_dim_size_to_factor
        )

    def _stacked_shape(members):
        (path, p), n = members[0], len(members)
        return ((n,) if is_layered(path) else ()) + tuple(p.shape)

    def init(params):
        v: dict = {}
        for jpath, members in jax_leaf_groups(params).items():
            shape, dev = _stacked_shape(members), members[0][1].device
            if _factored(shape):
                leaf = {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32, device=dev)}
            else:
                leaf = {"v": torch.zeros(shape, dtype=F32, device=dev)}
            nested_set(v, jpath, leaf)
        return {"v": v, "count": 0}

    def _stack(members):
        """The JAX leaf in float32: the layers' slices stacked, or the one
        leaf as it is."""
        if is_layered(members[0][0]):
            return torch.stack([t.to(F32) for _, t in members])
        return members[0][1].to(F32)

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        count = state["count"] + 1
        beta = 1.0 - (torch.tensor(float(count), dtype=F32) + 1.0) ** (-decay)
        g_groups = jax_leaf_groups(grads)
        new_params = tree_map(lambda p: None, params)
        new_v: dict = {}
        for jpath, members in jax_leaf_groups(params).items():
            g = _stack(g_groups[jpath])
            v = nested_get(state["v"], jpath)
            g2 = torch.square(g) + eps
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                r_factor = torch.rsqrt(vr / torch.mean(vr, dim=-1, keepdim=True) + eps)
                c_factor = torch.rsqrt(vc + eps)
                upd = g * r_factor[..., None] * c_factor[..., None, :]
                nested_set(new_v, jpath, {"vr": vr, "vc": vc})
            else:
                vv = beta * v["v"] + (1 - beta) * g2
                upd = g * torch.rsqrt(vv + eps)
                nested_set(new_v, jpath, {"v": vv})
            # update clipping by RMS, over the whole JAX leaf
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            p = _stack(members)
            new_p = p - lr * (upd + weight_decay * p)
            if is_layered(members[0][0]):
                for i, (path, old) in enumerate(members):
                    tree_set(new_params, path, new_p[i].to(old.dtype))
            else:
                path, old = members[0]
                tree_set(new_params, path, new_p.to(old.dtype))
        return new_params, {"v": new_v, "count": count}

    return Optimizer(init, update)


def make_optimizer(name: str, *, weight_decay: float = 0.0) -> Optimizer:
    """``sgd``, ``adam`` or ``adafactor`` with the JAX package's defaults."""
    if name == "sgd":
        return sgd(weight_decay=weight_decay)
    if name == "adam":
        return adam(weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def optimizer_state_axes(name: str, param_axes, param_shapes) -> Any:
    """Logical axes for the optimizer state, mirroring the param axes so
    FSDP/TP sharding carries over to the moments — except the params'
    ``fsdp_embed`` axis becomes ``opt_embed`` so ZeRO-1 can shard the
    moments while replicating the params.  ``param_axes`` is the model's
    ``param_axes()`` (one layer's axes standing for a layer list),
    ``param_shapes`` the param tree (tensors or fake tensors): it decides
    which Adafactor leaves are factored, on the stacked JAX leaf's
    shape, whose axes then carry the ``layers`` axis first."""
    def _opt(axes):
        if axes is None:
            return None
        return tuple("opt_embed" if a == "fsdp_embed" else a for a in axes)

    def _rename(t):
        if isinstance(t, dict):
            return {k: _rename(v) for k, v in t.items()}
        return _opt(t)

    opt_axes = _rename(param_axes)
    if name == "sgd":
        return {"mu": opt_axes}
    if name == "adam":
        return {"mu": opt_axes, "nu": opt_axes, "count": None}
    if name == "adafactor":
        def _factored(shape) -> bool:
            return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128

        v: dict = {}
        for jpath, members in jax_leaf_groups(param_shapes).items():
            (path, p), n = members[0], len(members)
            shape = ((n,) if is_layered(path) else ()) + tuple(p.shape)
            axes = nested_get(opt_axes, jpath)
            axes = tuple(axes) if axes is not None else (None,) * len(p.shape)
            if is_layered(path):
                axes = ("layers",) + axes
            if _factored(shape):
                nested_set(v, jpath, {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]})
            else:
                nested_set(v, jpath, {"v": axes})
        return {"v": v, "count": None}
    raise ValueError(name)
