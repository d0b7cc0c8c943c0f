"""Per-device counts of one step, read from the ops it dispatches: the
port's counterpart of ``repro/roofline/hlo_parse.py``.

The JAX package reads FLOPs, bytes and collectives from the compiled
program's HLO text.  The port runs eagerly and has no HLO: ``OpCounter``
is a ``TorchDispatchMode`` that sees every op the step runs, on real or
fake tensors (``FakeTensorMode``: shapes only, nothing allocated), on one
device or under a DTensor mesh whose process group may be the fake one
of the dry run.  It counts for ONE device:

* FLOPs: every op with a formula in ``torch.utils.flop_counter``'s
  registry — the matmuls, convolutions and attention of aten, and the
  port's kernels K1, K4 and K5, whose operators (``repro_torch::
  conv2d_fwd``, ``flash_attention_fwd``, ``ssd_fwd``) register theirs.
  The backward's ops are dispatched like the forward's, so they count;
  so does every layer of the Python loop over layers (which is why the
  port has no twin of ``repro/models/unroll.py``).
* bytes: each op's tensor operands plus its results (views and
  allocations move nothing and count nothing).  It is an eager count,
  op by op, with no fusion: an upper side of what a fused program moves.
* collective bytes by kind, with ``analysis.py``'s ring factors: an
  all-gather counts its result, a reduce-scatter, all-to-all or
  broadcast (``collective-permute``) its operand, an all-reduce twice
  its operand.
* the peak of live bytes: every storage from the op that creates it to
  the moment its last tensor is released, plus the storages of the
  arguments handed to ``track`` (the step's state and batch): the
  counterpart of ``memory_analysis()``'s argument + temp bytes.

Per device, not global: on a DTensor the mode steps aside
(``NotImplemented``), so DTensor's dispatch splits the op and the mode
sees what one rank computes and sends: the op on that rank's local
shards, and the collectives of every redistribution.  A DTensor op's
global count divided by the product of the sizes of the mesh
dimensions on which its output is ``Shard`` or ``Partial`` is exactly
its local op's count; a replicated output (gather mode's replicated
tail) counts whole on every device.  The ops DTensor runs on global
shapes to propagate shapes and strides are skipped.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collective -> (kind, ring factor, which side is the payload)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", 1, "result"),
    "all_gather_into_tensor_coalesced": ("all-gather", 1, "result"),
    "all_reduce": ("all-reduce", 2, "operand"),
    "all_reduce_coalesced": ("all-reduce", 2, "operand"),
    "reduce_scatter_tensor": ("reduce-scatter", 1, "operand"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1, "operand"),
    "all_to_all_single": ("all-to-all", 1, "operand"),
    "broadcast": ("collective-permute", 1, "operand"),
}
_FREE = {"empty", "empty_like", "empty_strided", "detach", "alias", "lift_fresh",
         "wait_tensor", "_to_copy_noop"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(...)``, then ``c.flops``,
    ``c.memory_bytes``, ``c.collective_bytes``, ``c.by_kind`` and
    ``c.peak_bytes`` (per device)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = 0.0
        self.memory_bytes = 0.0
        self.by_kind: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._storages: Dict[int, list] = {}  # key -> [nbytes, live tensors]
        self._skip = 0

    @property
    def collective_bytes(self) -> float:
        """Collective bytes of every kind."""
        return sum(self.by_kind.values())

    # --- live storages ------------------------------------------------------

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def track(self, *trees) -> None:
        """Count the storages of these trees' tensors (a DTensor's local
        shard) as live from now on: the step's arguments
        (``argument_bytes``)."""
        before = self.live_bytes
        for tree in trees:
            for leaf in _walk(tree):
                if isinstance(leaf, torch.Tensor):
                    self._hold(_local(leaf))
        self.argument_bytes += self.live_bytes - before

    # --- the mode -------------------------------------------------------------

    @contextlib.contextmanager
    def _skipping_shape_propagation(self):
        """DTensor runs some ops on global-shape fake tensors only to learn
        their outputs' shapes; those are no work of any device."""
        try:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator
        except ImportError:
            yield
            return
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            yield
            return
        counter = self

        def wrapped(self_, *args, **kwargs):
            counter._skip += 1
            try:
                return orig(self_, *args, **kwargs)
            finally:
                counter._skip -= 1

        setattr(ShardingPropagator, name, wrapped)
        try:
            yield
        finally:
            setattr(ShardingPropagator, name, orig)

    def __enter__(self):
        self._patch = self._skipping_shape_propagation()
        self._patch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor split it into per-rank ops
        out = func(*args, **kwargs)
        if self._skip or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        self.ops += 1
        name = func._overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in outs:
            self._hold(t)
        if name in _COLLECTIVE_OPS:
            kind, factor, side = _COLLECTIVE_OPS[name]
            payload = outs if side == "result" else ins
            self.by_kind[kind] += factor * sum(_nbytes(t) for t in payload)
            return out
        if name in _FREE or getattr(func, "is_view", False) or not outs:
            return out
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        self.memory_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _walk(getattr(tree, k))
    else:
        yield tree
