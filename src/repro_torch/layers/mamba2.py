"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) layer of the port.

Counterpart of ``repro/layers/mamba2.py``.  The full-sequence body runs
its chunked SSD scan through an ``ssd_fn`` — by default
``kernels.ops.ssd`` (K5, the hand-written Hopper kernel on the card),
where the JAX package runs its jnp ``_ssd_chunked``; the Pallas kernel
of ``repro/kernels/ssd.py`` computes the same scan.  ``ssd_fn`` returns
the final state too, so the prefill's cache needs no second pass.
Decode keeps O(1) state per token (conv window, SSM state) and stays
plain torch, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import ssd


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    nh = ssm.n_heads(cfg.d_model)
    return ssm, d_in, nh, ssm.head_dim, ssm.d_state, ssm.n_groups


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, dtype, device="cpu"):
    ssm, d_in, nh, hd, n, g = _dims(cfg)
    d = cfg.d_model
    conv_ch = d_in + 2 * g * n
    std = 1.0 / math.sqrt(d)
    proj_out = 2 * d_in + 2 * g * n + nh  # z, x, B, C, dt

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    return {
        "in_proj": {"kernel": (normal(d, proj_out) * std).to(device, dtype)},
        "conv_w": (normal(ssm.d_conv, conv_ch) * 0.1).to(device, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        # A = -exp(a_log), the mamba2 init of A in [1, 16]
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": {"kernel": (normal(d_in, d) * std / math.sqrt(2 * cfg.num_layers))
                     .to(device, dtype)},
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    ssm, d_in, nh, hd, n, g = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, g * n, g * n, nh], dim=-1)


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time.  x: (B,S,C), w: (K,C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """mamba2's gated RMSNorm of the scan output, then ``out_proj``."""
    y = y * F.silu(z)
    var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-5)).to(dtype)
    y = y * params["norm_scale"].to(dtype)
    return y @ params["out_proj"]["kernel"].to(dtype)


def mamba2_with_state(params, x: torch.Tensor, *, cfg: ModelConfig, ssd_fn=ssd):
    """Full-sequence mamba2 block body (pre-norm residual handled by the
    caller) that also returns the decode state after the last step:
    (y (B,S,d), {"conv": (B, d_conv-1, C), "ssm": (B, H, P, N)}).  The
    JAX package's ``apply_mamba2`` and ``models/transformer.py::
    _mamba_prefill`` in one."""
    ssm, d_in, nh, hd, n, g = _dims(cfg)
    dtype = cfg.compute_dtype
    bsz, s, _ = x.shape
    zxbcdt = x.to(dtype) @ params["in_proj"]["kernel"].to(dtype)
    z, xi, bmat, cmat, dt = _split_proj(zxbcdt, cfg)

    conv_in = torch.cat([xi, bmat, cmat], dim=-1)
    conv_state = conv_in[:, -(ssm.d_conv - 1):, :]
    conv_out = F.silu(_depthwise_conv(conv_in, params["conv_w"].to(dtype),
                                      params["conv_b"].to(dtype)))
    xi, bmat, cmat = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])  # (H,)

    xh = xi.reshape(bsz, s, nh, hd).float()
    bg = bmat.reshape(bsz, s, g, n).float()
    cg = cmat.reshape(bsz, s, g, n).float()

    y, final = ssd_fn(xh, dt, a, bg, cg, chunk=ssm.chunk_size)
    y = y + xh * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, d_in).to(dtype)
    return _gated_out(params, y, z, dtype), {"conv": conv_state, "ssm": final}


def apply_mamba2(params, x: torch.Tensor, *, cfg: ModelConfig, ssd_fn=ssd) -> torch.Tensor:
    """Full-sequence mamba2 block body (pre-norm residual handled by caller)."""
    return mamba2_with_state(params, x, cfg=cfg, ssd_fn=ssd_fn)[0]


# ---------------------------------------------------------------------------
# decode: O(1) state per step


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    ssm, d_in, nh, hd, n, g = _dims(cfg)
    conv_ch = d_in + 2 * g * n
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, hd, n), dtype=torch.float32, device=device),
    }


def decode_mamba2(params, x: torch.Tensor, state, *, cfg: ModelConfig):
    """Single-token recurrent step.  x: (B, 1, d).  Returns (y (B,1,d),
    new_state)."""
    ssm, d_in, nh, hd, n, g = _dims(cfg)
    dtype = cfg.compute_dtype
    bsz = x.shape[0]
    zxbcdt = x[:, 0].to(dtype) @ params["in_proj"]["kernel"].to(dtype)
    z, xi, bmat, cmat, dt = _split_proj(zxbcdt, cfg)

    conv_in = torch.cat([xi, bmat, cmat], dim=-1)  # (B, C)
    window = torch.cat([state["conv"], conv_in[:, None, :]], dim=1)  # (B,K,C)
    w = params["conv_w"].to(dtype)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w) + params["conv_b"].to(dtype))
    new_conv = window[:, 1:, :]
    xi, bmat, cmat = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"][None, :])  # (B,H)
    a = -torch.exp(params["a_log"])
    xh = xi.reshape(bsz, nh, hd).float()
    bg = bmat.reshape(bsz, g, n).repeat_interleave(nh // g, dim=1).float()
    cg = cmat.reshape(bsz, g, n).repeat_interleave(nh // g, dim=1).float()

    decay = torch.exp(dt * a[None, :])  # (B,H)
    new_ssm = state["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", xh, bg, dt)
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, cg)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(bsz, d_in).to(dtype)
    out = _gated_out(params, y, z, dtype)[:, None, :]
    return out, {"conv": new_conv, "ssm": new_ssm}
