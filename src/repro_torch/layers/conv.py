"""Convolution + pooling layers of the paper's CIFAR-10 CNN.

Counterpart of ``repro/layers/conv.py``: NHWC activations, HWIO
kernels.  The output-channel axis is the paper's "kernel" axis, the one
the cluster splits across devices.  ``apply_conv`` is the plain conv
(``kernels/ref.py::conv2d_ref``), differentiable through autograd; the
hand-written kernels come in through ``models/cnn.py::
conv_fn_for_backend("cuda")``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import conv2d_ref
from repro_torch.sharding.local import local_max_pool
from repro_torch.sharding.partitioning import is_dtensor


def init_conv(generator: torch.Generator, kh: int, kw: int, c_in: int,
              c_out: int, dtype=torch.float32, device="cpu"):
    """Fan-in scaled normal kernel, zero bias, drawn from ``generator``
    (a CPU generator: the same numbers on every device)."""
    fan_in = kh * kw * c_in
    w = torch.randn((kh, kw, c_in, c_out), generator=generator) / math.sqrt(fan_in)
    return {"kernel": w.to(device, dtype),
            "bias": torch.zeros((c_out,), dtype=dtype, device=device)}


def conv_axes():
    return {"kernel": (None, None, "conv_in", "conv_out"), "bias": ("conv_out",)}


def apply_conv(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, Cin) -> (B, H, W, Cout), SAME padding, stride 1."""
    y = conv2d_ref(x, params["kernel"].to(x.dtype))
    return y + params["bias"].to(y.dtype)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max-pool over the H and W axes of NHWC x (a DTensor on each
    rank's batch and channel shards)."""
    if is_dtensor(x):
        return local_max_pool(x, window, stride)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)
