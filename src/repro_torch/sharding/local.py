"""The port's counterparts of ``shard_map``: functions that run on the
local shards of DTensors, for the kernels and the in-place cache writes.

The attention kernel K4 and the SSD scan K5 are launched through a
ctypes call that a DTensor cannot go through, so under a mesh they run
on each rank's shard through ``local_map``:

* ``local_attention`` runs K4 on ``("batch", "act_heads")`` shards of
  the (B, H, S, D) operands.  Attention is local per head, so no
  collective enters the kernel.  Where the rules' head split does not
  fit both q's heads and k's (a kv-head count the model axis does not
  divide), the heads run whole on every rank, as GSPMD replicates them.
* ``local_ssd`` runs K5 on ``ssm_heads`` shards; the B and C groups go
  with their heads, or stay whole when there is one group.
* ``local_decode_attention`` is one decode token's attention against a
  cache whose slot axis may be sharded (``cache_seq`` on ``model``):
  each rank scores its own slots, and the softmax is combined across
  the slot shards with one max and two sum all-reduces (flash-decoding),
  so the cache is never gathered.
* ``local_embedding`` looks tokens up in a vocab-sharded table: each
  rank reads the rows it holds, and the result is a partial sum over
  the vocab's mesh axes (the JAX package's masked gather).
* ``local_cross_entropy`` is the loss's log-sum-exp and label pick on
  logits whose vocab may be sharded (megatron's ``vocab`` on ``model``):
  a max and two sums all-reduced over the vocab's mesh axes, never the
  (B, S, V) logits gathered.
* ``local_lrn`` and ``local_max_pool`` run the CNN's LRN and pooling on
  channel-sharded feature maps (megatron's ``act_conv``): pooling is
  per channel, and LRN's window reads two channels past each shard's
  edges, which an all-gather of the shards' edge channels brings in —
  never the feature maps.
* ``write_slots`` / ``write_layer`` write a new token's k and v (and the
  mamba states) into a cache in place.  On a DTensor only the rank that
  holds a slot writes it, in its own shard: an in-place index write
  into a sharded slot axis never becomes a full redistribution.

Every function takes plain tensors as well and then does what the
one-device code does.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional

import torch

from repro_torch.sharding.axes import PartitionSpec, placements_for_spec
from repro_torch.sharding.partitioning import is_dtensor, mesh_axis_sizes, spec_for_shape


def _entry(spec, d):
    return spec[d] if d < len(spec) else None


def _entry_size(entry, sizes) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[n] for n in names)


def grad_placements(in_pl, out_pl):
    """The placements of an input's gradient for ``local_map``: where the
    input is whole on every rank of a mesh dimension but the output is
    split (or a partial sum) along it, each rank's gradient is a partial
    sum; elsewhere it has the input's placements."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if isinstance(i, Replicate) and not isinstance(o, Replicate) else i
                 for i, o in zip(in_pl, out_pl))


def distribute_local(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` (the same on every rank) as a DTensor with ``placements``,
    each rank keeping its chunk, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def local_attention(attention_fn, rules):
    """``attention_fn`` (the flash-attention contract: q (B,H,S,D), k and v
    (B,KV,T,D)) on DTensor shards; plain tensors go straight through."""
    def fn(q, k, v, *, causal: bool = True, window=None):
        if not is_dtensor(q):
            return attention_fn(q, k, v, causal=causal, window=window)
        from torch.distributed.tensor.experimental import local_map

        mesh = q.device_mesh
        sizes = mesh_axis_sizes(mesh)
        axes = ("batch", "act_heads", None, None)
        sq = spec_for_shape(rules, q.shape, axes, sizes)
        sk = spec_for_shape(rules, k.shape, axes, sizes)
        if _entry(sq, 1) != _entry(sk, 1):  # GQA groups stay whole on every rank
            sq, sk = PartitionSpec(_entry(sq, 0)), PartitionSpec(_entry(sk, 0))
        pq = placements_for_spec(mesh.mesh_dim_names, sq)
        pk = placements_for_spec(mesh.mesh_dim_names, sk)
        body = functools.partial(attention_fn, causal=causal, window=window)
        gk = grad_placements(pk, pq)
        return local_map(body, out_placements=list(pq), in_placements=(pq, pk, pk),
                         in_grad_placements=(pq, gk, gk), device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v)

    return fn


def local_ssd(ssd_fn, rules):
    """``ssd_fn`` (x (B,S,H,P), dt (B,S,H), a (H,), bmat and cmat
    (B,S,G,N) -> y, final state (B,H,P,N)) on DTensor shards."""
    def fn(x, dt, a, bmat, cmat, *, chunk: int):
        if not is_dtensor(x):
            return ssd_fn(x, dt, a, bmat, cmat, chunk=chunk)
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        sizes = mesh_axis_sizes(mesh)
        sx = spec_for_shape(rules, x.shape, ("batch", None, "ssm_heads", None), sizes)
        bt, hd = _entry(sx, 0), _entry(sx, 2)
        g = bmat.shape[2]
        if hd is not None and g > 1 and g % _entry_size(hd, sizes):
            hd = None  # a rank's heads must read whole groups
        gd = hd if g > 1 else None

        def pl(*entries):
            return placements_for_spec(names, PartitionSpec(*entries))

        px, pb = pl(bt, None, hd, None), pl(bt, None, gd, None)
        ins = (px, pl(bt, None, hd), pl(hd), pb, pb)
        body = functools.partial(ssd_fn, chunk=chunk)
        return local_map(
            body, out_placements=(list(px), list(pl(bt, hd, None, None))),
            in_placements=ins, in_grad_placements=tuple(grad_placements(p, px) for p in ins),
            device_mesh=mesh, redistribute_inputs=True,
        )(x, dt, a, bmat, cmat)

    return fn


def as_dtensor(t, mesh, placements):
    """A DTensor as it is; a plain tensor (the same on every rank) as a
    DTensor with ``placements``."""
    if is_dtensor(t) or not isinstance(t, torch.Tensor):
        return t
    return distribute_local(t, mesh, placements)


def local_embedding(table, tokens):
    """``F.embedding(tokens, table)`` for a DTensor ``table`` (V, d): the
    table's d axis is gathered, its vocab shards stay, each rank looks up
    the tokens in its rows (zero elsewhere), and the output (tokens'
    shape + (d,)) is a partial sum over the mesh axes the vocab is split
    on, sharded like the tokens on the others."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements)
                  if isinstance(p, Shard) and p.dim == 0]
    t_pl = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    tokens = as_dtensor(tokens, mesh, [Replicate()] * mesh.ndim)
    tok_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(tokens.placements)]
    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(tok_pl)]
    n_rows = table.shape[0]

    def body(tab, tok):
        lo, rows = 0, tab.shape[0]
        if vocab_dims:
            coord = 0
            for i in vocab_dims:  # the rank's block of rows, in mesh order
                coord = coord * mesh.size(i) + mesh.get_local_rank(i)
            lo = coord * (n_rows // math.prod(mesh.size(i) for i in vocab_dims))
        hit = (tok >= lo) & (tok < lo + rows)
        out = F.embedding(torch.where(hit, tok - lo, torch.zeros_like(tok)), tab)
        return out * hit[..., None].to(out.dtype)

    return local_map(body, out_placements=out_pl, in_placements=(t_pl, tok_pl),
                     in_grad_placements=(grad_placements(t_pl, out_pl), tok_pl),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def _nhwc_placements(x):
    """Placements of NHWC x kept as they are on batch and channels,
    replicated on the spatial axes."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim in (0, 3) else Replicate()
                 for p in x.placements)


def local_max_pool(x, window: int, stride: int):
    """``layers/conv.py::max_pool`` on each rank's batch and channel shards."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.layers.conv import max_pool

    pl = _nhwc_placements(x)
    body = functools.partial(max_pool, window=window, stride=stride)
    return local_map(body, out_placements=list(pl), in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def local_lrn(x, *, size: int, alpha: float, beta: float, k: float):
    """``layers/norm.py::local_response_norm`` on NHWC DTensor x, each rank
    on its batch and channel shards; a channel split brings in the
    neighbours' ``size // 2`` edge channels (zeros past the ends) by an
    all-gather of the edges.  The same sums in the same order as the
    unsharded LRN."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.layers.norm import local_response_norm

    mesh = x.device_mesh
    pl = _nhwc_placements(x)
    chan = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 3]
    half = size // 2
    if len(chan) > 1:
        raise ValueError("local_lrn: channels split over more than one mesh axis")

    def body(xl):
        if not chan:
            return local_response_norm(xl, size=size, alpha=alpha, beta=beta, k=k)
        i = chan[0]
        m, r = mesh.size(i), mesh.get_local_rank(i)
        acc_t = torch.promote_types(xl.dtype, torch.float32)
        xf = xl.to(acc_t)
        edges = torch.cat([xf[..., :half], xf[..., -half:]], dim=-1)
        gather = (getattr(funcol, "all_gather_single_autograd", None)  # PyTorch 2.13+
                  or getattr(funcol, "all_gather_tensor_autograd", funcol.all_gather_tensor))
        every = gather(edges.contiguous(), xl.dim() - 1, (mesh, i))
        every = funcol.wait_tensor(every) if hasattr(every, "wait") else every
        zeros = torch.zeros_like(xf[..., :half])
        left = every[..., (r - 1) * 2 * half + half:r * 2 * half] if r > 0 else zeros
        right = every[..., (r + 1) * 2 * half:(r + 1) * 2 * half + half] if r < m - 1 else zeros
        padded = torch.cat([left, xf, right], dim=-1)
        sq = padded * padded
        c = xl.shape[-1]
        window = sum(sq[..., j:j + c] for j in range(size))
        return (xf / torch.pow(k + alpha * window, beta)).to(xl.dtype)

    return local_map(body, out_placements=list(pl), in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=mesh,
                     redistribute_inputs=True)(x)


class _SumOver(torch.autograd.Function):
    """Sum of the ranks' partial values over mesh dims ``dims``; the sum
    is whole on every rank, so its gradient goes back to each partial as
    it is."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        from torch.distributed import _functional_collectives as funcol

        for i in dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, i)))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def local_cross_entropy(logits, labels):
    """Per-token cross-entropy (B, S) float32 of DTensor ``logits`` (B, S,
    V) against ``labels`` (B, S), each rank on its batch rows and, where
    the vocab is split, its vocab columns."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if isinstance(p, Shard) and p.dim == 2]
    l_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                 for p in logits.placements)
    t_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in l_pl)
    labels = as_dtensor(labels, mesh, t_pl)
    n_vocab = logits.shape[2]

    def body(lg, lab):
        lg = lg.float()
        v_loc, lo = lg.shape[-1], 0
        if vocab_dims:
            coord = 0
            for i in vocab_dims:
                coord = coord * mesh.size(i) + mesh.get_local_rank(i)
            lo = coord * (n_vocab // math.prod(mesh.size(i) for i in vocab_dims))
        m = lg.detach().amax(-1, keepdim=True)
        for i in vocab_dims:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
        sumexp = _SumOver.apply(torch.exp(lg - m).sum(-1), mesh, vocab_dims)
        lab = lab.long()
        hit = (lab >= lo) & (lab < lo + v_loc)
        idx = torch.where(hit, lab - lo, torch.zeros_like(lab))
        picked = torch.gather(lg, -1, idx[..., None])[..., 0] * hit.to(lg.dtype)
        picked = _SumOver.apply(picked, mesh, vocab_dims)
        return m[..., 0] + torch.log(sumexp) - picked

    return local_map(body, out_placements=list(t_pl), in_placements=(l_pl, t_pl),
                     in_grad_placements=(l_pl, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def _decode_scores(q, k, q_pos, kv_pos, causal, window):
    """Masked scores (B,KV,G,S,T) in float32 (float64 stays float64)."""
    from repro_torch.layers.attention import NEG_INF, _split_gqa

    acc_t = torch.promote_types(q.dtype, torch.float32)
    qg = _split_gqa(q, k.shape[2]).to(acc_t)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(acc_t)) * q.shape[-1] ** -0.5
    mask = (kv_pos[:, None, :] >= 0).expand(-1, q_pos.shape[1], -1)
    if causal:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return scores.masked_fill(~mask[:, None, None], NEG_INF)


def local_decode_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                           window: Optional[int]):
    """Attention of decode queries q (B,S,H,D) against a cache k, v
    (B,T,KV,D) at positions q_pos (B,S) / kv_pos (B,T) (-1 = empty), in
    q's dtype: ``layers/attention.py::naive_attention`` on plain tensors;
    on DTensors each rank works on its shards of the cache."""
    from repro_torch.layers.attention import naive_attention

    if not is_dtensor(k):
        return naive_attention(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    pq, pqpos, pkpos, seq_dims = [], [], [], []
    # a slot split over one device is no split: that rank attends as the
    # one-device code does, and gives its bits
    for i, p in enumerate(k.placements):
        if isinstance(p, Shard) and p.dim == 0:
            pq.append(Shard(0)), pqpos.append(Shard(0)), pkpos.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 1:
            pq.append(Replicate()), pqpos.append(Replicate()), pkpos.append(Shard(1))
            if mesh.size(i) > 1:
                seq_dims.append(i)
        elif isinstance(p, Shard) and p.dim == 2:
            pq.append(Shard(2)), pqpos.append(Replicate()), pkpos.append(Replicate())
        else:
            pq.append(Replicate()), pqpos.append(Replicate()), pkpos.append(Replicate())

    def body(q, k, v, q_pos, kv_pos):
        if not seq_dims:
            return naive_attention(q, k, v, q_pos, kv_pos, causal=causal, window=window)
        scores = _decode_scores(q, k, q_pos, kv_pos, causal, window)
        m = scores.amax(-1, keepdim=True)
        for i in seq_dims:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
        p = torch.exp(scores - m)
        denom = p.sum(-1)  # (B,KV,G,S)
        out = torch.einsum("bkgst,btkd->bskgd", p, v.to(p.dtype))
        for i in seq_dims:
            denom = funcol.wait_tensor(funcol.all_reduce(denom, "sum", (mesh, i)))
            out = funcol.wait_tensor(funcol.all_reduce(out, "sum", (mesh, i)))
        out = out / denom.permute(0, 3, 1, 2)[..., None]
        b, s = q.shape[:2]
        return out.reshape(b, s, q.shape[2], q.shape[3]).to(q.dtype)

    q, q_pos, kv_pos = (as_dtensor(t, mesh, p) for t, p in
                        ((q, pq), (q_pos, pqpos), (kv_pos, pkpos)))
    return local_map(body, out_placements=pq, in_placements=(pq, k.placements, k.placements,
                                                            pqpos, pkpos),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, q_pos, kv_pos)


def _view_placements(dst, layer: Optional[int]) -> List:
    """dst's placements, for dst[layer] when a layer is given (the layer
    axis, 0, is never sharded)."""
    from torch.distributed.tensor import Shard

    if layer is None:
        return list(dst.placements)
    out = []
    for p in dst.placements:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("write into a cache sharded on its layer axis")
            out.append(Shard(p.dim - 1))
        else:
            out.append(p)
    return out


def write_slots(dst: torch.Tensor, slots, value, *, dim: int,
                layer: Optional[int] = None) -> None:
    """In place: ``view[(:,) * dim + (slots,)] = value`` for ``view`` =
    ``dst`` (``dst[layer]`` with a layer); ``slots`` an int (``value``
    without axis ``dim``) or a 1-D index tensor, ``value`` a tensor or a
    Python number.  On a DTensor every rank writes the slots its shard
    holds, and only those."""
    if not is_dtensor(dst):
        view = dst if layer is None else dst[layer]
        view[(slice(None),) * dim + (slots,)] = value
        return
    if isinstance(slots, int):
        if isinstance(value, torch.Tensor):
            value = value.unsqueeze(dim)
        slots = torch.tensor([slots], device=dst.device)
    from torch.distributed.tensor import Replicate, Shard

    mesh = dst.device_mesh
    vp = _view_placements(dst, layer)
    local = dst.to_local() if layer is None else dst.to_local()[layer]
    seq = [i for i, p in enumerate(vp) if isinstance(p, Shard) and p.dim == dim]
    if len(seq) > 1:
        raise ValueError("write_slots: the slot axis is sharded over more than one mesh axis")
    if isinstance(value, torch.Tensor):
        want = [Replicate() if i in seq else p for i, p in enumerate(vp)]
        value = (value.redistribute(mesh, want) if is_dtensor(value)
                 else distribute_local(value, mesh, want)).to_local()
    lo, n = 0, local.shape[dim]
    if seq:
        lo = mesh.get_local_rank(seq[0]) * n
    keep = ((slots >= lo) & (slots < lo + n)).nonzero()[:, 0]
    if keep.numel() == 0:
        return
    idx = (slice(None),) * dim + (slots[keep] - lo,)
    if isinstance(value, torch.Tensor):
        value = value.index_select(dim, keep.to(value.device)).to(local.dtype)
    local[idx] = value


def write_layer(dst: torch.Tensor, layer: int, value: torch.Tensor) -> None:
    """In place: ``dst[layer] = value`` (a stacked per-layer cache entry);
    on a DTensor each rank writes its own shard."""
    if not is_dtensor(dst):
        dst[layer] = value
        return
    vp = _view_placements(dst, layer)
    if is_dtensor(value):
        value = value.redistribute(dst.device_mesh, vp).to_local()
    else:
        value = distribute_local(value, dst.device_mesh, vp).to_local()
    dst.to_local()[layer].copy_(value)
