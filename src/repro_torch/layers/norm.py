"""Normalisation layers of the port.

Counterpart of ``repro/layers/norm.py``; only the CNN's
``local_response_norm`` is ported so far.  RMSNorm and LayerNorm come
with the model zoo.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc_t)
    c = x.shape[-1]
    half = size // 2
    padded = F.pad(xf * xf, (half, half))
    window = sum(padded[..., i : i + c] for i in range(size))
    return (xf / torch.pow(k + alpha * window, beta)).to(x.dtype)
