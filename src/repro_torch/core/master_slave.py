"""Compat shim — the master/slave runtime now lives in ``core/cluster/``.

The runtime is a layered package (transport -> codec -> protocol ->
plans -> scheduler -> cluster); see ``repro_torch/core/cluster/__init__.py``
for the map.  This module keeps the JAX package's ``core/master_slave.py``
import surface — the names its tests, benches and examples import,
including the seed-era private ones — as re-exports.  New code should
import from ``repro_torch.core.cluster`` directly.

Two transports ride behind the same ``HeteroCluster`` API:
``transport="inproc"`` (the seed behaviour: slave threads, queue pairs,
emulated bandwidth) and ``transport="tcp"`` (real OS subprocess slaves
over framed localhost sockets with measured link bandwidth).
"""
from __future__ import annotations

from repro_torch.core.backends import (  # noqa: F401  (seed-compatible aliases)
    numpy_conv as _conv,
    numpy_conv_vjp as _conv_vjp,
)
from repro_torch.core.cluster.cluster import (  # noqa: F401
    HeteroCluster,
    _np_probe,
    make_distributed_conv,
)
from repro_torch.core.cluster.codec import resolve_wire_dtype  # noqa: F401
from repro_torch.core.cluster.plans import (  # noqa: F401
    PARTITION_MODES,
    LayerPlan as _LayerPlan,
    strip_plan as _strip_plan,
)
from repro_torch.core.cluster.protocol import (  # noqa: F401
    TRAIN_OVER as _TRAIN_OVER,
    SlaveError as _SlaveError,
    bwd_shard as _bwd_shard,
    conv_shard as _conv_shard,
    slave_loop,
)
from repro_torch.core.cluster.scheduler import (  # noqa: F401
    LayerTiming,
    Pending as _Pending,
    TrainStepResult,
)
from repro_torch.core.cluster.transport import (  # noqa: F401
    InProcTransport as _Socket,
    SlaveLost,
    TCPListener,
    TCPSlaveEndpoint,
    TCPTransport,
    Transport,
)


def _slave_loop(sock, slowdown: float, backend_name: str, device: int):
    """Seed-signature wrapper: drive the protocol loop from a legacy
    ``_Socket`` (an ``InProcTransport``) instead of a bare endpoint."""
    return slave_loop(sock.slave_endpoint(), slowdown, backend_name, device)


__all__ = [
    "HeteroCluster",
    "make_distributed_conv",
    "LayerTiming",
    "TrainStepResult",
    "PARTITION_MODES",
    "resolve_wire_dtype",
    "Transport",
    "TCPTransport",
    "TCPSlaveEndpoint",
    "TCPListener",
    "SlaveLost",
]
