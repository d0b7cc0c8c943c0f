"""Dense layers of the port: multi-dimensional kernels.

Counterpart of ``repro/layers/linear.py`` (``init_dense``,
``apply_dense``): a kernel of shape ``in_dims + out_dims`` contracts the
last ``len(in_dims)`` axes of x.  The CNN's fc layer is the one-axis
case.  ``dense_axes`` gives a kernel's logical axes (sharding/axes.py).
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.partitioning import (
    flatten_last,
    is_dtensor,
    matmul,
    pin_grad,
    unflatten_last,
)


def _as_tuple(x):
    return (x,) if isinstance(x, int) else tuple(x)


def init_dense(generator: torch.Generator, in_dims, out_dims,
               dtype=torch.float32, *, scale: float = 1.0,
               use_bias: bool = False, device="cpu"):
    """Variance-scaling (fan-in) init, kernel shape = in_dims + out_dims,
    drawn from ``generator`` on the generator's device."""
    in_dims, out_dims = _as_tuple(in_dims), _as_tuple(out_dims)
    kernel = torch.randn(in_dims + out_dims, generator=generator,
                         device=generator.device) * scale / math.sqrt(math.prod(in_dims))
    params = {"kernel": kernel.to(device, dtype)}
    if use_bias:
        params["bias"] = torch.zeros(out_dims, dtype=dtype, device=device)
    return params


def dense_axes(in_axes, out_axes, use_bias=False):
    """Logical axes of a dense layer's params: the kernel's in_axes +
    out_axes, the bias's out_axes."""
    ax = {"kernel": tuple(in_axes) + tuple(out_axes)}
    if use_bias:
        ax["bias"] = tuple(out_axes)
    return ax


def apply_dense(params, x: torch.Tensor, *, n_in_dims: int = 1,
                dtype=None) -> torch.Tensor:
    """Contract the last ``n_in_dims`` dims of x with the kernel's leading
    dims, in ``dtype`` (x's dtype by default)."""
    dtype = x.dtype if dtype is None else dtype
    kernel = params["kernel"].to(dtype)
    k_in = math.prod(kernel.shape[:n_in_dims])
    out_dims = kernel.shape[n_in_dims:]
    if is_dtensor(x):  # reshapes that keep a DTensor's splits legal
        y = matmul(flatten_last(x.to(dtype), n_in_dims), pin_grad(kernel.reshape(k_in, -1)))
        y = unflatten_last(y, out_dims)
    else:
        lead = x.shape[: x.dim() - n_in_dims]
        y = x.to(dtype).reshape(*lead, k_in) @ kernel.reshape(k_in, -1)
        y = y.reshape(*lead, *out_dims)
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y
