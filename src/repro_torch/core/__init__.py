"""The paper's primary contribution: heterogeneity-aware kernel-sharded
model parallelism for convolutional layers (Marques, Falcao, Alexandre,
2017), ported to PyTorch, with its mesh generalisation
(``make_sharded_conv``).

Attribute access is lazy (PEP 562): ``from repro_torch.core import
HeteroCluster`` works, but merely importing ``repro_torch.core`` pulls
in nothing heavy — TCP slave subprocesses
(``-m repro_torch.core.cluster.protocol``) stay numpy-light at spawn.
"""
from __future__ import annotations

from repro_torch.lazy import lazy_exports

_EXPORTS = {
    # costmodel
    "ConvLayerSpec": "repro_torch.core.costmodel",
    "comm_time_s": "repro_torch.core.costmodel",
    "paper_network": "repro_torch.core.costmodel",
    "predict_step_time": "repro_torch.core.costmodel",
    "upload_bytes": "repro_torch.core.costmodel",
    "upload_elements": "repro_torch.core.costmodel",
    "upload_elements_nodes": "repro_torch.core.costmodel",
    # backends
    "available_backends": "repro_torch.core.backends",
    "get_backend": "repro_torch.core.backends",
    "probe_conv_time": "repro_torch.core.backends",
    "register_backend": "repro_torch.core.backends",
    # master/slave cluster (core/cluster/ package behind the shim)
    "HeteroCluster": "repro_torch.core.master_slave",
    "make_distributed_conv": "repro_torch.core.master_slave",
    # partitioner
    "allocate_kernels": "repro_torch.core.partitioner",
    "effective_times": "repro_torch.core.partitioner",
    "predicted_conv_time": "repro_torch.core.partitioner",
    "probe_device": "repro_torch.core.partitioner",
    "speedup": "repro_torch.core.partitioner",
    "workload_shares": "repro_torch.core.partitioner",
    # mesh sharding
    "make_sharded_conv": "repro_torch.core.conv_shard",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
