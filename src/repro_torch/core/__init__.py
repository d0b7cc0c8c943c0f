"""The paper's primary contribution: heterogeneity-aware kernel-sharded
model parallelism for convolutional layers (Marques, Falcao, Alexandre,
2017), ported to PyTorch.

Attribute access is lazy (PEP 562): ``from repro_torch.core import
HeteroCluster`` works, but merely importing ``repro_torch.core`` pulls
in nothing heavy — TCP slave subprocesses
(``-m repro_torch.core.cluster.protocol``) stay numpy-light at spawn.
"""
from __future__ import annotations

from repro_torch.lazy import lazy_exports

_EXPORTS = {
    # backends
    "available_backends": "repro_torch.core.backends",
    "get_backend": "repro_torch.core.backends",
    "probe_conv_time": "repro_torch.core.backends",
    "register_backend": "repro_torch.core.backends",
    # master/slave cluster
    "HeteroCluster": "repro_torch.core.cluster.cluster",
    "make_distributed_conv": "repro_torch.core.cluster.cluster",
    # partitioner
    "allocate_kernels": "repro_torch.core.partitioner",
    "effective_times": "repro_torch.core.partitioner",
    "predicted_conv_time": "repro_torch.core.partitioner",
    "probe_device": "repro_torch.core.partitioner",
    "speedup": "repro_torch.core.partitioner",
    "workload_shares": "repro_torch.core.partitioner",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
