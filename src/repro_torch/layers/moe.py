"""Mixture-of-Experts layer of the port: a top-k router and capacity-bound
expert FFNs over one card.

Counterpart of ``repro/layers/moe.py`` on its ``mesh is None`` path
(``apply_moe`` -> ``_moe_local`` with one expert shard).  The router
runs in float32 whatever the params' dtype (``init_moe`` stores it so);
each token's top-k experts are taken by probability, ties to the lower
expert index as ``jax.lax.top_k`` breaks them, and their gates are
renormalised with a floor of 1e-9.  Dispatch is sort-based, as in the
JAX package: a stable sort by expert id keeps, for each expert, the
first ``capacity`` of its tokens in token order; a token past capacity
is dropped from that expert (its slot points at the sentinel row T,
whose output is zero), not rerouted.  The expert products are batched
matmuls over the experts, plain products left to torch as the JAX
package leaves its einsums to XLA.

The JAX package adds the experts' outputs back with a scatter-add over
the token table; here each token gathers its k outputs from the slots
it was given and sums them, which is the same sum without atomics, so a
rerun on the card gives the same bits.  The expert-sharded paths (the
``shard_map`` psum over the ``model`` axis and the all-to-all dispatch)
need a mesh and come with sharding.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.layers.linear import init_dense
from repro_torch.layers.mlp import activation_fn


def init_moe(generator: torch.Generator, d_model: int, moe: MoEConfig, dtype,
             device="cpu"):
    """The router (d, E) in float32 and the experts' ``w_in``, ``w_gate``
    (E, d, ff) and ``w_out`` (E, ff, d) in ``dtype``, each drawn as
    N(0, 1/d_model) one tensor at a time."""
    e, ff = moe.num_experts, moe.expert_d_ff
    std = 1.0 / math.sqrt(d_model)

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=generator.device) * std
        return w.to(device, dtype)

    return {
        "router": init_dense(generator, (d_model,), (e,), torch.float32, device=device),
        "w_in": normal((e, d_model, ff)),
        "w_gate": normal((e, d_model, ff)),
        "w_out": normal((e, ff, d_model)),
    }


def _capacity(num_tokens: int, moe: MoEConfig) -> int:
    cap = int(num_tokens * moe.experts_per_token * moe.capacity_factor / moe.num_experts)
    return max(moe.experts_per_token, min(cap, num_tokens))


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values in index order (``torch.topk`` promises no order
    among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_tables(top_idx: torch.Tensor, top_gate: torch.Tensor, num_experts: int,
                     capacity: int):
    """Sort-based GShard dispatch.

    top_idx/top_gate: (T, k) expert assignment per token.  Returns, as
    the JAX package does, token_table (E, C) int32 (an index into
    [0, T], T the sentinel), gate_table (E, C) float32 and the fraction
    of assignments per expert (E,); and, for the port's combine, each
    assignment's flat slot (T*k,) into the (E*C) tables, E*C where the
    assignment was dropped."""
    t, k = top_idx.shape
    a = t * k
    dev = top_idx.device
    flat_e = top_idx.reshape(a)
    flat_gate = top_gate.reshape(a).float()
    flat_tok = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(a, device=dev) - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted

    sentinel = num_experts * capacity
    slot = torch.where(rank < capacity, flat_e * capacity + rank,
                       torch.full_like(rank, sentinel))
    # dropped assignments all write the sentinel entry, which is cut off
    token_table = torch.full((sentinel + 1,), t, dtype=torch.int32, device=dev)
    token_table[slot] = flat_tok
    gate_table = torch.zeros((sentinel + 1,), dtype=torch.float32, device=dev)
    gate_table[slot] = flat_gate
    return (token_table[:-1].reshape(num_experts, capacity),
            gate_table[:-1].reshape(num_experts, capacity),
            counts.float() / a, slot)


def _expert_ffn(xs: torch.Tensor, w_in, w_gate, w_out, activation: str) -> torch.Tensor:
    """xs: (E, C, d); weights (E, d, ff) / (E, ff, d) -> (E, C, d)."""
    act = activation_fn(activation)
    h = torch.bmm(xs, w_in)
    g = torch.bmm(xs, w_gate)
    return torch.bmm(act(g) * h, w_out)


def _moe_local(x_flat: torch.Tensor, params, *, moe: MoEConfig, activation: str,
               dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat: (T, d) -> (out (T, d) in ``dtype``, aux float32 scalar)."""
    t, d = x_flat.shape
    e, k = moe.num_experts, moe.experts_per_token
    cap = _capacity(t, moe)

    logits = x_flat.float() @ params["router"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    top_gate, top_idx = _top_k(probs, k)
    top_gate = top_gate / top_gate.sum(-1, keepdim=True).clamp_min(1e-9)

    token_table, gate_table, frac_tokens, slot = _dispatch_tables(top_idx, top_gate, e, cap)

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], dim=0)
    xs = x_pad[token_table.long()]  # (E, C, d)
    ys = _expert_ffn(xs.to(dtype), params["w_in"].to(dtype), params["w_gate"].to(dtype),
                     params["w_out"].to(dtype), activation)
    ys = ys * gate_table[..., None].to(ys.dtype)

    # each token's k outputs, gathered from its slots (a zero row for a
    # dropped one) and summed
    ys_pad = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))], dim=0)
    out = ys_pad[slot].reshape(t, k, d).sum(1)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    aux = e * torch.sum(frac_tokens * probs.mean(0)) * moe.load_balance_loss_weight
    return out, aux


def apply_moe(params, x: torch.Tensor, *, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                                      torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux_loss)."""
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.arch_id}: apply_moe needs cfg.moe")
    b, s, d = x.shape
    out, aux = _moe_local(x.reshape(b * s, d), params, moe=moe, activation=cfg.activation,
                          dtype=cfg.compute_dtype)
    return out.reshape(b, s, d).to(x.dtype), aux
