"""Feed-forward layers of the port.

Counterpart of ``repro/layers/mlp.py``: ``w_in`` (and ``w_gate`` when
gated) from d_model to d_ff, the activation, ``w_out`` back.  The JAX
package pins the sharded layouts here with ``constrain``; one card needs
no such pins.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.linear import apply_dense, init_dense


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


def apply_mlp(params, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    dtype = cfg.compute_dtype
    act = activation_fn(cfg.activation)
    h = apply_dense(params["w_in"], x, dtype=dtype)
    if "w_gate" in params:
        h = act(apply_dense(params["w_gate"], x, dtype=dtype)) * h
    else:
        h = act(h)
    return apply_dense(params["w_out"], h, dtype=dtype)
