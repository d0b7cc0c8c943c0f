"""Logical-axis -> mesh-axis rule system of the port (MaxText-style).

Counterpart of ``repro/sharding/axes.py``, rule for rule.  Every tensor
is annotated with *logical* axis names ("batch", "embed", "heads",
"mlp", "experts", ...), and a rule table maps each logical axis to zero
or more mesh axes.  Four tables are shipped:

* ``LOGICAL_RULES_GATHER`` — the *paper-faithful* scheme: the weights of
  the compute-dominant layer are sharded along their output-feature
  axis, every activation is replicated (the "master gathers every layer
  output" protocol of Algorithms 1 & 2 expressed as shardings).
* ``LOGICAL_RULES_MEGATRON`` — column/row-parallel pairing plus
  sequence-parallel activations and FSDP parameter sharding along the
  data axis.
* ``LOGICAL_RULES_FSDP`` and ``LOGICAL_RULES_ZERO1`` — no tensor
  parallelism: the model axis is folded into the batch, parameters
  sharded over every chip (ZeRO-3) or replicated with the optimizer
  state sharded (ZeRO-1).

``AxisRules.spec`` gives a ``PartitionSpec``: the port's own small twin
of ``jax.sharding.PartitionSpec``, a tuple with one entry per tensor
dimension (a mesh-axis name, a tuple of names, or ``None``), trailing
``None``s trimmed.  ``placements_for_spec`` turns a spec into the DTensor
placements of a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the mesh axes.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh-axis
    name, or a tuple of mesh-axis names (the dimension split over each of
    them, in order).  Equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Immutable logical->mesh axis mapping."""

    rules: Mapping[str, MeshAxes]
    name: str = "custom"

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        """Build a PartitionSpec for a tensor whose dims carry the given
        logical names (``None`` = unsharded dim)."""
        out = []
        seen: set = set()
        for ax in logical_axes:
            if ax is None or ax not in self.rules:
                out.append(None)
                continue
            mesh_ax = self.rules[ax]
            # A mesh axis may be consumed at most once per spec; later
            # logical axes that map to an already-used mesh axis fall back
            # to replication.
            if mesh_ax is None:
                out.append(None)
            elif isinstance(mesh_ax, tuple):
                free = tuple(m for m in mesh_ax if m not in seen)
                seen.update(free)
                out.append(free if free else None)
            elif mesh_ax in seen:
                out.append(None)
            else:
                seen.add(mesh_ax)
                out.append(mesh_ax)
        while out and out[-1] is None:  # canonical form
            out.pop()
        return PartitionSpec(*out)

    def replace(self, **updates: MeshAxes) -> "AxisRules":
        """A copy with these logical axes mapped anew."""
        new = dict(self.rules)
        new.update(updates)
        return AxisRules(rules=new, name=self.name + "+")


def _rules(d: Mapping[str, MeshAxes], name: str) -> AxisRules:
    return AxisRules(rules=dict(d), name=name)


# Logical axes used across the framework:
#   batch         global batch dim of activations
#   seq           sequence dim of activations
#   embed         d_model dim of activations / weights
#   heads         attention query-head dim
#   kv_heads      attention kv-head dim
#   head_dim      per-head feature dim
#   mlp           FFN hidden dim
#   vocab         vocabulary dim
#   experts       MoE expert dim
#   expert_mlp    per-expert FFN hidden dim
#   ssm_heads     mamba head dim
#   ssm_state     mamba state dim (never sharded)
#   conv_out      conv output-channel dim (the paper's kernel axis)
#   conv_in       conv input-channel dim
#   layers        stacked-layer dim of scanned params (never sharded)
#   fsdp_embed    embed dim of *parameters* when FSDP shards them on data

# Paper-faithful ("gather"): the weights of each compute-dominant matmul
# (the "kernel sets") are sharded along their *output-feature* axis over
# `model`; the matmul runs sharded ("slaves convolve their kernels"); its
# output is immediately all-gathered ("the master receives all feature
# maps", Alg. 1 l.19-22); every downstream op runs replicated (= the
# master computing the rest of the network serially -- the Amdahl
# bottleneck the paper reports).  The batch dim stays sharded over
# pod/data, matching the paper keeping the batch local.
#
# Axis pairs:  "act_*_col" pins the layout right after the column matmul
# (sharded in BOTH modes -- the distributed compute); "act_*" pins the
# layout handed to downstream ops (gather mode: None => forced all-gather;
# megatron mode: "model" => stays sharded, consumed row-parallel).
LOGICAL_RULES_GATHER = _rules(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "embed": None,
        "act_embed": None,       # residual stream: replicated (master-held)
        "act_seq": None,
        "act_mlp_col": "model",  # column-matmul output: sharded...
        "act_mlp": None,         # ...then gathered (paper's Alg.1 gather)
        "act_heads_col": "model",
        "act_heads": None,
        "heads": "model",        # weight out-feature axes: the kernel shards
        "kv_heads": "model",
        "head_dim": None,
        "cache_seq": None,       # decode cache held replicated (master)
        "heads_in": None,        # wo consumed replicated (master computes it)
        "mlp": "model",
        "mlp_in": None,          # w_out consumed replicated
        "vocab": None,           # FC/loss layers on the master: replicated
        "experts": "model",
        "expert_mlp": None,
        "ssm_heads": "model",
        "ssm_inner": "model",
        "ssm_state": None,
        "conv_out": "model",
        "conv_in": None,
        "act_conv_col": "model",
        "act_conv": None,        # feature maps gathered to the master
        "layers": None,
        "fsdp_embed": None,      # no FSDP in the faithful scheme
        "opt_embed": None,
    },
    name="gather",
)

# Beyond-paper ("megatron"): column->row parallel pairing (one all-reduce/
# reduce-scatter per sublayer instead of two all-gathers), sequence-
# parallel residual stream, FSDP parameter sharding over pod/data, and a
# model-sharded vocab/logits head.
LOGICAL_RULES_MEGATRON = _rules(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "embed": None,
        "act_embed": None,
        "act_seq": "model",      # sequence-parallel residual stream
        "act_mlp_col": "model",
        "act_mlp": "model",      # stays sharded -> row-parallel w_out
        "act_heads_col": "model",
        "act_heads": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "cache_seq": "model",
        "heads_in": "model",     # wo row-parallel
        "mlp": "model",
        "mlp_in": "model",       # w_out row-parallel
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "ssm_heads": "model",
        "ssm_inner": "model",
        "ssm_state": None,
        "conv_out": "model",
        "conv_in": None,
        "act_conv_col": "model",
        "act_conv": "model",     # feature maps stay channel-sharded
        "layers": None,
        "fsdp_embed": ("pod", "data"),  # ZeRO-3 style param sharding
        "opt_embed": ("pod", "data"),
    },
    name="megatron",
)


# Beyond-paper ("fsdp"): NO tensor parallelism — the model axis is folded
# into the batch/FSDP dimension (512-way data parallel + ZeRO-3).  For
# models whose per-layer weights fit one chip (<~7B dense) this removes
# every activation collective; the only comm left is the per-layer
# parameter all-gather + gradient reduce-scatter.  The SS Perf lever for
# collective-bound small-dense pairs (yi-6b, minicpm-2b).
LOGICAL_RULES_FSDP = _rules(
    {
        "batch": ("pod", "data", "model"),
        "seq": None,
        "embed": None,
        "act_embed": None,
        "act_seq": None,
        "act_mlp_col": None,
        "act_mlp": None,
        "act_heads_col": None,
        "act_heads": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "cache_seq": "model",    # decode cache slots sharded over model
        "heads_in": None,
        "mlp": None,
        "mlp_in": None,
        "vocab": None,
        "experts": "model",      # MoE still needs expert parallelism
        "expert_mlp": None,
        "ssm_heads": None,
        "ssm_inner": None,
        "ssm_state": None,
        "conv_out": None,
        "conv_in": None,
        "act_conv_col": None,
        "act_conv": None,
        "layers": None,
        "fsdp_embed": ("pod", "data", "model"),  # ZeRO-3 over every chip
        "opt_embed": ("pod", "data", "model"),
    },
    name="fsdp",
)

# Beyond-paper ("zero1"): parameters REPLICATED (no per-layer all-gather
# at all), optimizer state sharded over every chip.  For dense models
# whose bf16 params fit HBM (<~7B) this leaves only the gradient
# reduction as communication — the cheapest schedule on the menu.
LOGICAL_RULES_ZERO1 = AxisRules(
    rules={**LOGICAL_RULES_FSDP.rules,
           "fsdp_embed": None,
           "opt_embed": ("pod", "data", "model")},
    name="zero1",
)


def placements_for_spec(mesh_dim_names: Sequence[str], spec: Sequence[MeshAxes]) -> Tuple:
    """The DTensor placements of ``spec`` on a mesh with these dimension
    names: ``Shard(d)`` on every mesh dimension that tensor dimension d
    is split over (a tuple entry such as ``("pod", "data")`` gives
    ``Shard(d)`` on each of those mesh dimensions, which DTensor splits
    in mesh order, as the JAX mesh does), ``Replicate()`` on the rest.
    A mesh axis the mesh lacks is ignored."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh_dim_names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name in mesh_dim_names:
                out[list(mesh_dim_names).index(name)] = Shard(d)
    return tuple(out)
