"""Dense layers of the port.

Counterpart of ``repro/layers/linear.py`` (``init_dense``,
``apply_dense``) for the CNN's one fc layer: a (d_in, d_out) kernel.
The JAX package's multi-axis kernels, init scale and logical-axis
metadata have no caller here yet.
"""
from __future__ import annotations

import math

import torch


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, *, use_bias: bool = False, device="cpu"):
    """Variance-scaling (fan-in) init of a (d_in, d_out) kernel, drawn
    from ``generator`` (a CPU generator)."""
    kernel = torch.randn((d_in, d_out), generator=generator) / math.sqrt(d_in)
    params = {"kernel": kernel.to(device, dtype)}
    if use_bias:
        params["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return params


def apply_dense(params, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ kernel (+ bias), in x's dtype."""
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y
