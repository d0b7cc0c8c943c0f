"""The master/slave cluster runtime, layered bottom-up:

    transport.py — the wire: ``InProcTransport`` (queues + emulated
                   bandwidth, slave threads) and ``TCPTransport`` (real
                   framed sockets, subprocess slaves)
    codec.py     — the fp16/bf16 compact wire codec + canonical byte
                   accounting, independent of any transport
    protocol.py  — message grammar + the slave loop (Algorithm 2);
                   doubles as the TCP slave process entry (``-m``)
    plans.py     — per-layer partition plans: kernel/spatial/auto axis
                   resolution, Eq. 1(+comm) unit counts, strip/halo math
    scheduler.py — the pipelined schedules (microbatch double-buffering,
                   forward chain, fwd+bwd train chain) over any transport
    cluster.py   — ``HeteroCluster`` (the master, Algorithm 1) wiring it
                   all together

Attribute access is lazy (PEP 562) so that TCP slave subprocesses —
which import ``repro_torch.core.cluster.protocol`` — never pay for
torch or the master-side stack until a backend needs it.
"""
from __future__ import annotations

from repro_torch.lazy import lazy_exports

_EXPORTS = {
    "HeteroCluster": ".cluster",
    "make_distributed_conv": ".cluster",
    "Transport": ".transport",
    "InProcTransport": ".transport",
    "SharedNIC": ".transport",
    "TCPTransport": ".transport",
    "TCPSlaveEndpoint": ".transport",
    "TCPListener": ".transport",
    "TRANSPORT_KINDS": ".transport",
    "SlaveLost": ".transport",
    "HEARTBEAT": ".transport",
    "is_heartbeat": ".transport",
    "resolve_wire_dtype": ".codec",
    "wire_nbytes": ".codec",
    "TRAIN_OVER": ".protocol",
    "SlaveError": ".protocol",
    "slave_loop": ".protocol",
    "PARTITION_MODES": ".plans",
    "LayerPlan": ".plans",
    "strip_plan": ".plans",
    "check_plan": ".plans",
    "LayerTiming": ".scheduler",
    "TrainStepResult": ".scheduler",
    "Pending": ".scheduler",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
