"""Logical-axis sharding of the port on a ``torch.distributed`` DeviceMesh
(counterpart of ``repro/sharding``)."""
from repro_torch.sharding.axes import (
    LOGICAL_RULES_FSDP,
    LOGICAL_RULES_GATHER,
    LOGICAL_RULES_MEGATRON,
    LOGICAL_RULES_ZERO1,
    AxisRules,
    PartitionSpec,
    logical_to_mesh_spec,
    placements_for_spec,
)
from repro_torch.sharding.partitioning import (
    constrain,
    constrain_logical_tree,
    distribute_tree,
    get_active_mesh,
    mesh_context,
    param_sharding_for_tree,
    spec_for_shape,
)

__all__ = [
    "AxisRules",
    "LOGICAL_RULES_FSDP",
    "LOGICAL_RULES_GATHER",
    "LOGICAL_RULES_MEGATRON",
    "LOGICAL_RULES_ZERO1",
    "PartitionSpec",
    "logical_to_mesh_spec",
    "placements_for_spec",
    "constrain",
    "constrain_logical_tree",
    "distribute_tree",
    "get_active_mesh",
    "mesh_context",
    "param_sharding_for_tree",
    "spec_for_shape",
]
