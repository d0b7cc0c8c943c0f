"""Mixture-of-Experts layer of the port: a top-k router and capacity-bound
expert FFNs, on one card or expert-parallel over a mesh.

Counterpart of ``repro/layers/moe.py``.  The router
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
rerun on the card gives the same bits.

Under a mesh (``mesh`` with a ``model`` axis) the body runs on each
rank's shards through ``local_map``, the port's ``shard_map``: tokens
sharded on the batch axes and replicated over ``model`` ("all slaves
receive the same inputs"), each ``model`` rank holding a contiguous
slice of the experts (or, where the axis does not divide the experts,
as mixtral's 8 on 16, a slice of every expert's d_ff), and the ranks'
contributions summed by an all-reduce over ``model`` (the JAX psum;
the master gathering the feature maps of Algorithm 1).  With
``moe.dispatch == "alltoall"`` the tokens are sharded over ``model``
too, and two ``all_to_all_single`` calls move only the routed tokens to
the experts' owners and back.  The load-balance aux is computed per
token shard and averaged over the mesh, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.distributed import _functional_collectives as funcol

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


def moe_axes():
    return {
        "router": {"kernel": ("fsdp_embed", None)},  # router always replicated on model
        "w_in": ("experts", "fsdp_embed", "expert_mlp"),
        "w_gate": ("experts", "fsdp_embed", "expert_mlp"),
        "w_out": ("experts", "expert_mlp", "fsdp_embed"),
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


def _route(x_flat: torch.Tensor, router_kernel: torch.Tensor, moe: MoEConfig):
    """Router probs (T, E) and the dispatch tables of ``_dispatch_tables``."""
    t = x_flat.shape[0]
    logits = x_flat.float() @ router_kernel.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    top_gate, top_idx = _top_k(probs, moe.experts_per_token)
    top_gate = top_gate / top_gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, _dispatch_tables(top_idx, top_gate, moe.num_experts, _capacity(t, moe))


def _combine(ys: torch.Tensor, slot: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Each token's k outputs gathered from its slots of ys (E', C, d) (a
    zero row for a slot outside ys) and summed: (T, d)."""
    d = ys.shape[-1]
    ys_pad = torch.cat([ys.reshape(-1, d), ys.new_zeros((1, d))], dim=0)
    return ys_pad[slot].reshape(t, k, d).sum(1)


def _moe_local(x_flat: torch.Tensor, params, *, moe: MoEConfig, activation: str,
               dtype, expert_shards: int = 1, expert_rank: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat: (T, d) -> (out (T, d) in ``dtype``, aux float32 scalar).
    ``params``' expert weights are this rank's slice: E/expert_shards
    experts (the rank's rows of the dispatch table) when the experts are
    sharded, else a d_ff slice of every expert."""
    t, d = x_flat.shape
    e, k = moe.num_experts, moe.experts_per_token
    cap = _capacity(t, moe)
    probs, (token_table, gate_table, frac_tokens, slot) = _route(
        x_flat, params["router"]["kernel"], moe)

    e_loc = params["w_in"].shape[0]
    if expert_shards > 1 and e_loc < e:
        # experts sharded: keep only this rank's rows of the dispatch table
        start = expert_rank * e_loc
        token_table = token_table[start:start + e_loc]
        gate_table = gate_table[start:start + e_loc]
        local = slot - start * cap
        slot = torch.where((local >= 0) & (local < e_loc * cap), local,
                           torch.full_like(local, e_loc * cap))

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], dim=0)
    xs = x_pad[token_table.long()]  # (E, C, d)
    ys = _expert_ffn(xs.to(dtype), params["w_in"].to(dtype), params["w_gate"].to(dtype),
                     params["w_out"].to(dtype), activation)
    ys = ys * gate_table[..., None].to(ys.dtype)
    out = _combine(ys, slot, t, k)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    aux = e * torch.sum(frac_tokens * probs.mean(0)) * moe.load_balance_loss_weight
    return out, aux


def apply_moe(params, x: torch.Tensor, *, cfg: ModelConfig, mesh=None,
              token_axes: Tuple[str, ...] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux_loss).

    ``mesh`` + ``token_axes``: under a mesh the flattened token dim is
    sharded over ``token_axes`` (those that divide it, typically
    ("pod", "data")), the experts over ``model`` (or d_ff over ``model``
    when E % model != 0), and the outputs are summed over ``model``."""
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.arch_id}: apply_moe needs cfg.moe")
    b, s, d = x.shape
    if mesh is None or "model" not in mesh.mesh_dim_names:
        out, aux = _moe_local(x.reshape(b * s, d), params, moe=moe,
                              activation=cfg.activation, dtype=cfg.compute_dtype)
        return out.reshape(b, s, d).to(x.dtype), aux
    return _apply_moe_mesh(params, x, cfg=cfg, mesh=mesh, token_axes=token_axes)


def _apply_moe_mesh(params, x, *, cfg: ModelConfig, mesh, token_axes):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.local import as_dtensor, grad_placements

    moe = cfg.moe
    b, s, d = x.shape
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    n_model = sizes["model"]
    mdim = names.index("model")
    experts_sharded = moe.num_experts % n_model == 0
    ff_sharded = (not experts_sharded) and moe.expert_d_ff % n_model == 0

    kept, prod = [], 1  # only shard the token dim where it divides
    for a in token_axes:
        if a in sizes and (b * s) % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    use_a2a = (moe.dispatch == "alltoall" and experts_sharded
               and (b * s) % (prod * n_model) == 0)
    tok_axes = kept + ["model"] if use_a2a else kept

    def pl(shard_dim_of):
        return [Shard(shard_dim_of[n]) if n in shard_dim_of else Replicate() for n in names]

    tok_pl = pl({a: 0 for a in tok_axes})
    rep = pl({})
    if experts_sharded:
        w_pl = (pl({"model": 0}),) * 3
    elif ff_sharded:
        w_pl = (pl({"model": 2}), pl({"model": 2}), pl({"model": 1}))
    else:  # fully replicated experts (smoke-scale fallback)
        w_pl = (rep,) * 3
    n_tok = math.prod(sizes[a] for a in tok_axes)
    dtype, act = cfg.compute_dtype, cfg.activation

    x = as_dtensor(x, mesh, rep)
    x_flat = x.redistribute(mesh, pl({a: 0 for a in kept})).reshape(b * s, d)
    router, w_in, w_gate, w_out = (as_dtensor(t, mesh, rep) for t in (
        params["router"]["kernel"], params["w_in"], params["w_gate"], params["w_out"]))

    if use_a2a:
        def body(x_loc, router, w_in, w_gate, w_out):
            out, aux = _moe_a2a_local(x_loc, router, w_in, w_gate, w_out, moe=moe,
                                      activation=act, dtype=dtype, mesh=mesh, mdim=mdim,
                                      n_model=n_model)
            return out, aux / n_tok
        out_pl = tok_pl
    else:
        def body(x_loc, router, w_in, w_gate, w_out):
            p_loc = {"router": {"kernel": router}, "w_in": w_in, "w_gate": w_gate,
                     "w_out": w_out}
            rank = mesh.get_local_rank(mdim)
            out, aux = _moe_local(x_loc, p_loc, moe=moe, activation=act, dtype=dtype,
                                  expert_shards=n_model if experts_sharded else 1,
                                  expert_rank=rank)
            # every model rank routes the same tokens: one rank carries the
            # aux (and, with the experts whole everywhere, the output), so
            # that each is an exact partial sum over `model`
            if not (experts_sharded or ff_sharded) and rank:
                out = torch.zeros_like(out)
            return out, (aux if rank == 0 else torch.zeros_like(aux)) / n_tok
        # each model rank holds a partial sum of the tokens' outputs
        out_pl = [Partial() if i == mdim else p for i, p in enumerate(tok_pl)]
    ins = (tok_pl, rep) + w_pl
    # the aux: a mean over the token shards (and one model rank's value)
    aux_pl = [Partial() if (n in tok_axes or n == "model") else Replicate() for n in names]
    out, aux = local_map(
        body, out_placements=(out_pl, aux_pl), in_placements=ins,
        in_grad_placements=tuple(grad_placements(p, out_pl) for p in ins),
        device_mesh=mesh, redistribute_inputs=True,
    )(x_flat, router, w_in, w_gate, w_out)
    # the psum over `model` (an all-reduce) and the aux's pmean over the mesh
    out = out.redistribute(mesh, tok_pl)
    aux = aux.redistribute(mesh, rep)
    return out.reshape(b, s, d).to(x.dtype), aux


def _all_to_all(t: torch.Tensor, mesh, mdim: int) -> torch.Tensor:
    """Tiled all-to-all over the mesh's ``model`` dimension along axis 0:
    block i of every rank goes to rank i, the blocks received in rank
    order."""
    a2a = getattr(funcol, "all_to_all_single_autograd", funcol.all_to_all_single)
    out = a2a(t.contiguous(), None, None, (mesh, mdim))
    return funcol.wait_tensor(out) if hasattr(out, "wait") else out


def _moe_a2a_local(x_loc, router, w_in, w_gate, w_out, *, moe: MoEConfig, activation: str,
                   dtype, mesh, mdim: int, n_model: int):
    """All-to-all expert dispatch (the JAX package's ``_apply_moe_a2a``
    body): every rank routes only its own tokens, packs per-expert
    capacity buffers, and two all-to-alls move the routed tokens to the
    experts' owners and back.  Returns (out (T_loc, d), aux)."""
    t, d = x_loc.shape
    e, k = moe.num_experts, moe.experts_per_token
    e_loc = e // n_model
    cap = _capacity(t, moe)
    probs, (token_table, gate_table, frac, slot) = _route(x_loc, router, moe)

    x_pad = torch.cat([x_loc, x_loc.new_zeros((1, d))], dim=0)
    xs = x_pad[token_table.long()].to(dtype)  # (E, cap, d): the send buffers
    # forward: rows [i*e_loc:(i+1)*e_loc] go to model-rank i
    recv = _all_to_all(xs, mesh, mdim)  # n_model source blocks of (e_loc, cap, d)
    recv = recv.reshape(n_model, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n_model * cap, d)
    ys = _expert_ffn(recv, w_in.to(dtype), w_gate.to(dtype), w_out.to(dtype), activation)
    # return: block j of each rank goes back to source rank j
    ys = ys.reshape(e_loc, n_model, cap, d).transpose(0, 1).reshape(e, cap, d)
    back = _all_to_all(ys, mesh, mdim)  # (E, cap, d): expert-major rows, our tokens
    back = back * gate_table[..., None].to(back.dtype)
    out = _combine(back, slot, t, k)
    aux = e * torch.sum(frac * probs.mean(0)) * moe.load_balance_loss_weight
    return out, aux
