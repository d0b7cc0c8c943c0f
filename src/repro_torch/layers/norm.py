"""Normalisation layers of the port: RMSNorm, LayerNorm, and the paper
CNN's local response normalisation.

Counterpart of ``repro/layers/norm.py``.  RMSNorm and LayerNorm compute
in float32 and return x's dtype, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.local import local_lrn
from repro_torch.sharding.partitioning import is_dtensor


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_axes():
    return {"scale": ("embed_norm",)}


def apply_rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_axes():
    return {"scale": ("embed_norm",), "bias": ("embed_norm",)}


def apply_layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def init_norm(kind: str, d: int, dtype=torch.float32, device="cpu"):
    if kind == "rmsnorm":
        return init_rmsnorm(d, dtype, device)
    if kind == "layernorm":
        return init_layernorm(d, dtype, device)
    raise ValueError(f"unknown norm {kind!r}")


def norm_axes(kind: str):
    return rmsnorm_axes() if kind == "rmsnorm" else layernorm_axes()


def apply_norm(kind: str, params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if kind == "rmsnorm":
        return apply_rmsnorm(params, x, eps)
    return apply_layernorm(params, x, eps)


def local_response_norm(
    x: torch.Tensor, *, size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
    k: float = 2.0,
) -> torch.Tensor:
    """Cross-channel LRN over NHWC feature maps (the paper's CNN
    "normalisation layer", cuda-convnet / AlexNet style):
    ``x / (k + alpha * sum of x^2 over a +-size/2 channel window)^beta``.

    The JAX package's arithmetic, not ``F.local_response_norm``, which
    scales alpha by 1/size and wants NCHW.  Computed in float32 (float64
    stays float64), returned in x's dtype."""
    if is_dtensor(x):  # channel shards (sharding/local.py)
        return local_lrn(x, size=size, alpha=alpha, beta=beta, k=k)
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc_t)
    c = x.shape[-1]
    half = size // 2
    padded = F.pad(xf * xf, (half, half))
    window = sum(padded[..., i : i + c] for i in range(size))
    return (xf / torch.pow(k + alpha * window, beta)).to(x.dtype)
