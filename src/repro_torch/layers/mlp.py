"""Feed-forward layers of the port.

Counterpart of ``repro/layers/mlp.py``: ``w_in`` (and ``w_gate`` when
gated) from d_model to d_ff, the activation, ``w_out`` back.  Under a
mesh, ``rules`` pin the layouts as the JAX package does: the hidden
activation sharded right after the column matmul (``act_mlp_col``),
then the mode's layout (``act_mlp``: gathered in gather mode, kept
sharded for the row-parallel ``w_out`` in megatron mode).  Without a
mesh the pins do nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.linear import apply_dense, dense_axes, init_dense
from repro_torch.sharding.partitioning import constrain


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "squared_relu":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype, *,
             gated: bool = True, device="cpu"):
    p = {
        "w_in": init_dense(generator, d_model, d_ff, dtype, device=device),
        "w_out": init_dense(generator, d_ff, d_model, dtype, device=device),
    }
    if gated:
        p["w_gate"] = init_dense(generator, d_model, d_ff, dtype, device=device)
    return p


def mlp_axes(*, gated: bool = True):
    ax = {
        "w_in": dense_axes(("fsdp_embed",), ("mlp",)),
        "w_out": dense_axes(("mlp_in",), ("fsdp_embed",)),
    }
    if gated:
        ax["w_gate"] = dense_axes(("fsdp_embed",), ("mlp",))
    return ax


def apply_mlp(params, x: torch.Tensor, *, cfg: ModelConfig, rules=None) -> torch.Tensor:
    dtype = cfg.compute_dtype
    act = activation_fn(cfg.activation)
    h = apply_dense(params["w_in"], x, dtype=dtype)
    if "w_gate" in params:
        h = act(apply_dense(params["w_gate"], x, dtype=dtype)) * h
    else:
        h = act(h)
    h = constrain(h, rules, "batch", None, "act_mlp_col")
    h = constrain(h, rules, "batch", None, "act_mlp")
    y = apply_dense(params["w_out"], h, dtype=dtype)
    return constrain(y, rules, "batch", "act_seq", "act_embed")
