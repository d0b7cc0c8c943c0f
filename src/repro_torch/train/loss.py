"""Loss functions of the port's LM training.

Counterpart of ``repro/train/loss.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.local import local_cross_entropy
from repro_torch.sharding.partitioning import is_dtensor


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits (B, S, V) of any float
    dtype; labels (B, S) integer.  ``z_loss`` adds the log-normaliser
    penalty; ``mask`` (B, S) weights the tokens (the mean over its sum,
    at least 1).

    Computed in fp32 with the gather trick (no (B, S, V) one-hot), as
    the JAX package does; DTensor logits on each rank's shards
    (``sharding/local.py::local_cross_entropy``, which takes no z_loss)."""
    if is_dtensor(logits):
        if z_loss:
            raise ValueError("softmax_cross_entropy: z_loss on DTensor logits")
        nll = local_cross_entropy(logits, labels)
    else:
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)  # (B, S)
        picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return torch.mean(nll)
