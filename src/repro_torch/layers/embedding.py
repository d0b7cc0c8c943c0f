"""Token embedding, logits head, and rotary position embeddings.

Counterpart of ``repro/layers/embedding.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_embedding(generator: torch.Generator, vocab_size: int, d_model: int,
                   dtype=torch.float32, device="cpu"):
    table = torch.randn((vocab_size, d_model), generator=generator,
                        device=generator.device)
    return {"table": table.to(device, dtype)}


def embed_tokens(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(tokens, params["table"]).to(dtype)


def logits_from_embedding(params, x: torch.Tensor, dtype) -> torch.Tensor:
    """Tied read-out: x @ table.T"""
    return x.to(dtype) @ params["table"].to(dtype).T


# ---------------------------------------------------------------------------
# RoPE


def rope_frequencies(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
