"""Apply logical-axis shardings to tensors and trees of the port.

Counterpart of ``repro/sharding/partitioning.py``.  ``spec_for_shape``
and ``filter_spec_for_mesh`` are the same logic.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
the mesh axes, a sharded tensor a ``DTensor``:

* ``mesh_context(mesh)`` activates a mesh for the enclosed region (the
  JAX package's ``compat.mesh_context``; ``get_active_mesh`` reads it).
  Inside it, a plain tensor that meets a DTensor counts as replicated
  (``implicit_replication``), as a constant does under ``jax.jit``.
* ``constrain`` / ``constrain_shaped`` redistribute a DTensor to the
  rule's placements (``with_sharding_constraint``).  Outside an active
  mesh, or on a plain tensor, they return their input: every caller
  that passes no mesh runs exactly as it did before the mesh existed.
* ``param_sharding_for_tree`` maps a tree of logical-axis tuples to a
  tree of placements, ``distribute_tree`` puts a tree of tensors on the
  mesh with it.

Trees are the port's: nested dicts, with per-layer lists (``tree.py``).
An axes tree may hold one tuple for a whole layer list; it applies to
every layer.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.axes import AxisRules, PartitionSpec, placements_for_spec

_ACTIVE_MESH = contextvars.ContextVar("repro_torch_active_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Activate ``mesh`` for the enclosed region (``None`` activates
    nothing)."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    token = _ACTIVE_MESH.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE_MESH.reset(token)


def get_active_mesh():
    """The mesh activated by ``mesh_context`` in this context, or None."""
    return _ACTIVE_MESH.get()


def mesh_axis_sizes(mesh) -> dict:
    """{mesh axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def split_dims(x) -> int:
    """How many of DTensor ``x``'s dims are split over a mesh dim of more
    than one device (0 for a plain tensor: a split over one device is no
    split)."""
    if not is_dtensor(x):
        return 0
    from torch.distributed.tensor import Shard

    return len({p.dim for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and x.device_mesh.size(i) > 1})


def filter_spec_for_mesh(mesh_axis_names: Sequence[str], spec: PartitionSpec) -> PartitionSpec:
    """Drop mesh axes not present on this mesh from a PartitionSpec."""
    names = set(mesh_axis_names)

    def _filter(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return PartitionSpec(*[_filter(e) for e in spec])


def spec_for_shape(
    rules: AxisRules,
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    mesh_axis_sizes: dict,
) -> PartitionSpec:
    """Shape-aware logical->mesh spec.

    Walks the dims of a concrete shape and maps each logical axis to its
    mesh axes, *dropping* any mesh axis that (a) is not on the mesh,
    (b) was already consumed by an earlier dim, or (c) does not evenly
    divide the dim size.  This keeps every spec legal for architectures
    whose head/expert/vocab counts do not divide the mesh (e.g. hymba's
    25 heads, mixtral's 8 experts on a 16-way model axis).
    """
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    out = []
    seen: set = set()
    for dim, ax in zip(shape, logical_axes):
        if ax is None or ax not in rules.rules:
            out.append(None)
            continue
        mesh_ax = rules.rules[ax]
        if mesh_ax is None:
            out.append(None)
            continue
        cands = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        kept = []
        prod = 1
        for m in cands:
            if m not in mesh_axis_sizes or m in seen:
                continue
            if dim % (prod * mesh_axis_sizes[m]) != 0:
                continue
            kept.append(m)
            prod *= mesh_axis_sizes[m]
        seen.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placements_for(mesh, rules: AxisRules, shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]]) -> Tuple:
    """The DTensor placements of a tensor of ``shape`` with these logical
    axes on ``mesh`` (``spec_for_shape``, then ``placements_for_spec``)."""
    spec = spec_for_shape(rules, shape, logical_axes, mesh_axis_sizes(mesh))
    return placements_for_spec(mesh.mesh_dim_names, spec)


def constrain(x: torch.Tensor, rules: Optional[AxisRules],
              *logical_axes: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names.

    A no-op outside an active mesh, without rules, or on a plain tensor,
    so that layer code runs unchanged on one device.  Shape-aware: mesh
    axes that do not evenly divide the corresponding dim are dropped.
    """
    return constrain_shaped(x, rules, *logical_axes)


def constrain_shaped(x: torch.Tensor, rules: Optional[AxisRules],
                     *logical_axes: Optional[str]) -> torch.Tensor:
    """Shape-aware constraint: a DTensor is redistributed to the placements
    the rules give its shape on the active mesh."""
    mesh = get_active_mesh()
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    want = placements_for(mesh, rules, x.shape, logical_axes)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


class _PinGrad(torch.autograd.Function):
    """Identity whose backward lays the incoming gradient out as the
    forward's output (a partial sum's gradient whole on each rank)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate

        ctx.mesh = y.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and a 2-D w.  On a DTensor x the
    sequence-parallel split of x's inner leading dims is gathered first,
    and the gradient that comes back to the product is laid out as the
    product was: the matmul folds x's leading dims into one, and a batch
    split and a sequence split folded together are not a layout DTensor
    can propagate shapes through on fake tensors."""
    if not is_dtensor(x):
        return x @ w
    return _PinGrad.apply(gather_inner_leading(x, x.dim() - 1) @ w)


def pin_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``; on a DTensor, its gradient is laid out as ``t`` is before it
    goes further back (so the backward of a reshape that made ``t`` meets
    the layout the forward had)."""
    return _PinGrad.apply(t) if is_dtensor(t) else t


def flatten_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x.flatten(-n)``.  On a DTensor the flattened dims other than the
    first are gathered first (a split there is no layout of the merged
    dim), and the gradient that comes back is laid out as the flattened
    tensor was, so the backward's unflatten meets no split it cannot
    take."""
    if not is_dtensor(x):
        return x.flatten(x.dim() - n)
    from torch.distributed.tensor import Replicate, Shard

    first = x.dim() - n
    want = [Replicate() if isinstance(p, Shard) and p.dim > first else p
            for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return pin_grad(x.flatten(first))


def unflatten_last(x: torch.Tensor, sizes) -> torch.Tensor:
    """``x.unflatten(-1, sizes)``.  A DTensor split on its last dim into
    shards that do not hold whole rows of ``sizes[0]`` (hymba's 50 SSD
    heads over 16 ranks) is gathered on that dim first, as GSPMD would
    re-lay it out."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = x.dim() - 1
        dims = [i for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == last]
        ways = 1
        for i in dims:
            ways *= x.device_mesh.size(i)
        if dims and sizes[0] % ways:
            x = x.redistribute(x.device_mesh, [Replicate() if i in dims else p
                                               for i, p in enumerate(x.placements)])
    return x.unflatten(-1, tuple(sizes))


def gather_inner_leading(x: torch.Tensor, n_lead: int) -> torch.Tensor:
    """A DTensor whose leading dims 1..n_lead-1 (a sequence split, as
    megatron's ``act_seq``) are sharded, all-gathered on them: the
    sequence-parallel gather before a projection, which then folds its
    leading dims with only the batch split.  Anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if isinstance(p, Shard) and 0 < p.dim < n_lead else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) or x is None


def _map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over ``tree``'s leaves, ``axes_tree`` read as a
    prefix of it: a tuple (or None) stands for every leaf below it, and a
    dict of axes applies to every element of a layer list."""
    if _is_axes_leaf(axes_tree):
        if isinstance(tree, dict):
            return {k: _map_axes(fn, axes_tree, v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [_map_axes(fn, axes_tree, v) for v in tree]
        return fn(axes_tree, tree)
    if isinstance(tree, list):
        if isinstance(axes_tree, list):
            return [_map_axes(fn, a, v) for a, v in zip(axes_tree, tree)]
        return [_map_axes(fn, axes_tree, v) for v in tree]
    return {k: _map_axes(fn, axes_tree[k], v) for k, v in tree.items()}


def spec_tree(rules: AxisRules, logical_tree: Any, shape_tree: Any, mesh_axis_sizes: dict) -> Any:
    """The shape-aware ``PartitionSpec`` of every tensor of ``shape_tree``
    (``spec_for_shape`` with its logical axes, on a mesh of these axis
    sizes); None for a leaf that is not a tensor."""
    def one(axes, t):
        if t is None or not hasattr(t, "shape"):
            return None
        axes = axes if axes is not None else (None,) * len(t.shape)
        return spec_for_shape(rules, t.shape, axes, mesh_axis_sizes)

    return _map_axes(one, logical_tree, shape_tree)


def param_sharding_for_tree(mesh, logical_tree: Any, rules: AxisRules,
                            shape_tree: Any = None) -> Any:
    """Map a tree of logical-axis tuples to a tree of DTensor placements
    (a tuple per tensor).

    ``logical_tree`` mirrors the tensor tree but holds tuples of logical
    axis names (or None) per dim.  If ``shape_tree`` (a matching tree of
    tensors) is given, specs are shape-aware (divisibility-checked) and
    the result mirrors ``shape_tree``.
    """
    names = mesh.mesh_dim_names
    if shape_tree is None:
        def _one(axes):
            spec = filter_spec_for_mesh(names, rules.spec(*(axes or ())))
            return placements_for_spec(names, spec)

        def walk(t):
            if _is_axes_leaf(t):
                return _one(t)
            if isinstance(t, list):
                return [walk(v) for v in t]
            return {k: walk(v) for k, v in t.items()}

        return walk(logical_tree)

    specs = spec_tree(rules, logical_tree, shape_tree, mesh_axis_sizes(mesh))
    return _map_axes(lambda _, spec: None if spec is None else placements_for_spec(names, spec),
                     None, specs)


def distribute_tree(tree: Any, mesh, placements_tree: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with its
    placements (every rank holds the whole tensor, as the tests and the
    launchers build it from one seed, and keeps its shard).  Leaves that
    are not tensors (a Python step count) stay as they are."""
    from torch.distributed.tensor import distribute_tensor

    def one(placements, t):
        if not isinstance(t, torch.Tensor) or placements is None:
            return t
        return distribute_tensor(t, mesh, placements)

    return _zip_map(one, placements_tree, tree)


def _zip_map(fn, placements_tree, tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, placements_tree[k], v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, p, v) for p, v in zip(placements_tree, tree)]
    return fn(placements_tree, tree)


def constrain_logical_tree(tree: Any, rules: AxisRules, axes_tree: Any) -> Any:
    """``constrain`` over a tree guided by a logical-axes tree.  Used to
    pin gradient layouts to the parameter layout (a reduce-scatter
    instead of an all-reduce)."""
    def one(axes, x):
        if not isinstance(x, torch.Tensor):
            return x
        axes = axes if axes is not None else (None,) * x.dim()
        return constrain_shaped(x, rules, *axes)

    return _map_axes(one, axes_tree, tree)
