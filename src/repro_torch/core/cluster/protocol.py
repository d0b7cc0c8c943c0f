"""The master/slave message protocol and the slave loop (Algorithm 2).

Transport-agnostic: a slave drives any endpoint exposing ``send``/
``recv`` — the in-proc queue view of ``InProcTransport`` when the slave
is a thread, or a ``TCPSlaveEndpoint`` when the slave is a real OS
process.  Message grammar on the wire:

    ("probe", {probe_kwargs})          -> float seconds
    ("ping", payload)                  -> payload echoed (bandwidth probe)
    ("conv", (x, W))                   -> y
    ("bwd",  (x, W, g))                -> (dx, dw)
    ("sconv", (x_halo, W, pt, pb))     -> y strip (spatial mode)
    ("sbwd", (x_halo, W, g, pt, pb))   -> (dx_halo, dw) (spatial)
    "trainOver"                        -> slave loop exits

The weight slot ``W`` is one of three things.  A raw kernel array is
cached per op; ``None`` means "reuse the kernel you cached for this
op" — the pipelined schedules pay the weight traffic once per layer.
A ``codec.WeightRef(key, version, w)`` is the VERSIONED weight cache:
with ``w`` attached the slave stores it under ``(key, version)``; with
``w=None`` the slave must already hold that exact version (a miss or a
version mismatch is a master bug and raises).  The versioned cache is
what lets a serve master ship a ~24-byte token instead of
re-broadcasting static kernels on every slab.  A compute exception
ships back as a ``SlaveError`` (the master re-raises it at the
matching gather) so a broken backend fails loudly instead of hanging
the protocol.

Two serve loops share the grammar: ``slave_loop`` computes each op on
ONE backend (a leaf device), while ``sub_master_loop`` computes it over
a whole inner ``HeteroCluster`` — the two-tier hierarchy's middle node,
a slave upward and a master downward (``--group-slowdowns`` on the
CLI; see ``core/cluster/hierarchy.py``).

Run as a module, this file IS the TCP slave process — spawned by the
master on this host, or hand-launched on ANY host that can reach the
master's listener:

    python -m repro_torch.core.cluster.protocol --host H --port P \
        [--device I] [--slowdown 1.5] [--backend cuda] \
        [--transport tcp|shm] [--wire-dtype fp16] [--wire-codec SPEC] \
        [--heartbeat-s 0.5] \
        [--auth-env REPRO_CLUSTER_AUTH] [--connect-timeout-s 60] \
        [--group-slowdowns 1,1 --group-backends cuda,numpy ...]

It connects back to the master's listener (retrying while the master is
still binding), presents the cluster auth token (read from the env var
named by ``--auth-env``), identifies itself with a
``("hello", device, {"backend", "slowdown"})`` frame, and waits for the
master's ``("welcome", assigned_device)`` — the master owns device
numbering, so a hand-launched slave may omit ``--device`` entirely and
take whatever slot the cluster assigns.  With ``--heartbeat-s`` it
beats liveness frames from a side thread so a master with a heartbeat
deadline can tell "busy convolving" from "dead".  It then serves ops
until "trainOver" or EOF and leaves via ``os._exit`` so native runtime
threads (a CUDA context) can never hang the interpreter at exit.

``--backend`` defaults to ``cuda``, the hand-written kernel on the card;
the slave resolves it before it connects, so a host without a card
refuses to join instead of failing its first op.  ``numpy``,
``torch:cpu`` and ``sim`` run on the CPU when asked for.
"""
from __future__ import annotations

import time
import traceback
from typing import Tuple

import numpy as np

from repro_torch.core import backends, spans
from repro_torch.core.cluster.codec import WeightRef

TRAIN_OVER = "trainOver"


class SlaveError:
    """A slave's exception, shipped to the master instead of silently
    killing the slave (which would hang the master's gather)."""

    def __init__(self, device: int, tb: str):
        self.device = device
        self.tb = tb


def _zeros(like, shape):
    """float32 zeros of ``shape`` where ``like`` lives: a tensor's
    device, else the host's numpy."""
    shape = tuple(shape)
    return like.new_zeros(shape) if hasattr(like, "new_zeros") else np.zeros(shape, np.float32)


def conv_shard(backend, x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Backend conv with the 0-kernel and 0-batch fast paths: comp-aware
    shares (or a very slow device) may legally allocate 0 kernels — or,
    on the batch axis, 0 rows — which not every backend kernel tolerates
    (a CUDA launch with an empty grid is refused; sim flops scale with N).
    The zeros lie where the operands do."""
    if w.shape[-1] == 0 or x.shape[0] == 0:
        return _zeros(x, tuple(x.shape[:-1]) + (w.shape[-1],))
    return backend.conv(x, w)


def bwd_shard(backend, x, w, g) -> Tuple[np.ndarray, np.ndarray]:
    """Backend conv_vjp with the 0-kernel/0-batch fast paths (see
    conv_shard).  An empty batch slice contributes a zero dW, which the
    master's batch-axis all-reduce sums away."""
    if w.shape[-1] == 0 or x.shape[0] == 0:
        return _zeros(x, x.shape), _zeros(x, w.shape)
    return backend.conv_vjp(x, w, g)


def run_op(backend, op: str, operands: tuple):
    """One member's part of an op: the wire op ``op`` on ``operands``,
    its kernel resolved in slot 1, on ``backend`` — what a slave answers
    a message with, and what the master computes for its own part and
    for a lost member's."""
    if op == "conv":
        return conv_shard(backend, *operands)
    if op == "bwd":
        return bwd_shard(backend, *operands)
    if op == "sconv":  # spatial: a height strip + halo, full kernel
        return backends.strip_conv(backend, *operands)
    if op == "sbwd":  # spatial backward: halo dX + full-kernel dW
        return backends.strip_conv_vjp(backend, *operands)
    raise ValueError(f"unknown op {op}")


def _resolve_weights(w, op: str, cached_w: dict, wcache: dict):
    """Resolve an op's weight slot against both slave-side caches: the
    legacy per-op slot (raw array / ``None``) and the versioned
    ``WeightRef`` cache (one kernel per key — memory stays bounded by
    the number of live layers)."""
    if isinstance(w, WeightRef):
        if w.w is not None:
            wcache[w.key] = (w.version, w.w)
            return w.w
        hit = wcache.get(w.key)
        if hit is None:
            raise RuntimeError(
                f"weight-cache miss: no kernel cached for key {w.key!r} "
                f"(master sent a bare version token first)"
            )
        version, kernel = hit
        if version != w.version:
            raise RuntimeError(
                f"weight-cache version mismatch for key {w.key!r}: "
                f"cached v{version}, master referenced v{w.version}"
            )
        return kernel
    if w is None:
        return cached_w[op]
    cached_w[op] = w
    return w


def slave_loop(endpoint, slowdown: float, backend_name: str, device: int):
    """Algorithm 2, asynchronous: drain ops in FIFO order — read
    inputs/kernels, convolve with this device's backend, write outputs.
    No per-op ack: the master may queue several ops ahead (the pipeline);
    results stream back in issue order.  Returns on "trainOver" or when
    the master's side of the link goes away (EOF).

    Each op's compute, the emulated slowdown's sleep left out, is the
    span ``device.shard`` (labels ``device``, ``backend``, ``op``) while
    a torch profiler records: in the master's process for an in-process
    slave; in a slave process (tcp, shm) in that process's own session,
    which nothing reads yet."""
    backend = None
    cached_w = {}  # last kernel shard per op: pipelined microbatches after
    #                the first send w=None instead of retransmitting it
    wcache = {}  # versioned weight cache: key -> (version, kernel)
    while True:
        try:
            msg = endpoint.recv()
        except (EOFError, OSError):
            return  # master gone: nothing left to serve
        if isinstance(msg, str) and msg == TRAIN_OVER:
            return
        op, payload = msg
        if op == "ping":  # bandwidth probe: echo, no compute, no slowdown
            endpoint.send(payload)
            continue
        try:
            if backend is None:
                backend = backends.get_backend(backend_name)
            if op == "probe":
                endpoint.send(
                    backends.probe_conv_time(backend, slowdown=slowdown, **payload)
                )
                continue
            t0 = time.perf_counter()
            x, w, *rest = payload
            out = run_op(
                backend, op, (x, _resolve_weights(w, op, cached_w, wcache), *rest)
            )
            t1 = time.perf_counter()
            if spans.recording():
                spans.record("device.shard", t0, t1, device=device,
                             backend=backend_name, op=op)
            if slowdown > 1.0:
                # reprolint: allow=clock-injection -- slowdown emulation IS a real delay: it stretches measured compute to the emulated device's speed
                time.sleep((t1 - t0) * (slowdown - 1.0))
        except Exception:
            endpoint.send(SlaveError(device, traceback.format_exc()))
            continue
        endpoint.send(out)


def sub_master_loop(endpoint, cluster, device: int):
    """The TWO-TIER serve loop: Algorithm 2's grammar toward the root,
    a full ``HeteroCluster`` master toward the group.  A sub-master is
    a protocol node that answers the SAME wire ops as ``slave_loop``
    but computes each one over its inner cluster — per-layer
    kernel/spatial/batch/auto partitioning, pipelining, and the group's
    own fault tolerance all live behind this seam, invisible to the
    root except as capacity changes.

    Op semantics at this tier:

    * ``("probe", kw)`` re-probes every GROUP member and answers the
      aggregate Eq. 1 time (``plans.group_aggregate_time``: member
      compute rates sum) — the root prices the whole group as one
      device, and a member lost inside the group shows up here as a
      capacity drop the root re-plans on.
    * ``("conv", ...)`` / ``("bwd", ...)`` run the scheduler's
      ``group_forward`` / ``group_backward`` over the inner cluster —
      zero-row slices from the root's batch plan short-circuit, and
      the bwd answer is (dX rows, the group's FULL summed dW), the
      term the root's exact all-reduce sums.
    * ``("sconv", ...)`` / ``("sbwd", ...)`` fall back to the inner
      MASTER's backend (strip ops don't decompose over batch groups);
      a hierarchy root plans the batch axis, so these only arrive from
      legacy callers.
    * ``"trainOver"`` / EOF shut the inner cluster down and return.

    The weight slot resolves through the same per-op + versioned caches
    as a leaf slave, so the root's ~24-byte ``WeightRef`` tokens work
    unchanged one tier down."""
    from repro_torch.core.backends import strip_conv, strip_conv_vjp
    from repro_torch.core.cluster.plans import group_aggregate_time
    from repro_torch.core.cluster.scheduler import group_backward, group_forward

    cached_w = {}
    wcache = {}

    def ensure_probed():
        # A root that pins its own probe_times never forwards ("probe",
        # kw) down here, but the inner planner still needs member times
        # before its first share split — self-probe once with the stock
        # admit workload.
        if cluster.probe_times is None:
            cluster.probe(
                image_size=16, in_channels=3, kernel_size=3,
                num_kernels=8, batch=4, repeats=1,
            )

    try:
        while True:
            try:
                msg = endpoint.recv()
            except (EOFError, OSError):
                return  # root gone: the group follows it down
            if isinstance(msg, str) and msg == TRAIN_OVER:
                return
            op, payload = msg
            if op == "ping":  # root bandwidth probe: echo, never forwarded
                endpoint.send(payload)
                continue
            try:
                if op == "probe":
                    endpoint.send(group_aggregate_time(cluster.probe(**payload)))
                    continue
                if op == "conv":
                    x, w = payload
                    w = _resolve_weights(w, op, cached_w, wcache)
                    ensure_probed()
                    out = group_forward(cluster, x, w)
                elif op == "bwd":
                    x, w, g = payload
                    w = _resolve_weights(w, op, cached_w, wcache)
                    ensure_probed()
                    out = group_backward(cluster, x, w, g)
                elif op == "sconv":
                    xh, w, pt, pb = payload
                    w = _resolve_weights(w, op, cached_w, wcache)
                    out = strip_conv(cluster._master_backend, xh, w, pt, pb)
                elif op == "sbwd":
                    xh, w, g, pt, pb = payload
                    w = _resolve_weights(w, op, cached_w, wcache)
                    out = strip_conv_vjp(
                        cluster._master_backend, xh, w, g, pt, pb
                    )
                else:  # pragma: no cover
                    raise ValueError(f"unknown op {op}")
            except Exception:
                endpoint.send(SlaveError(device, traceback.format_exc()))
                continue
            endpoint.send(out)
    finally:
        cluster.shutdown()


def hello_frame(
    device: int, backend: str, slowdown: float, extra: dict = None
) -> tuple:
    """The join handshake: requested device slot (-1 = let the master
    assign one) plus the metadata the master records for membership —
    what an externally-launched slave brings that a spawned one was
    configured with.  ``extra`` extends the open meta dict without
    touching the grammar: a sub-master adds ``{"group": {"size": n,
    "bandwidth_mbps": min_internal}}`` so the root can fold the group's
    internal bottleneck into its uplink pricing."""
    meta = {"backend": backend, "slowdown": slowdown}
    if extra:
        meta.update(extra)
    return ("hello", device, meta)


def parse_hello(frame) -> Tuple[int, dict]:
    """(requested_device, meta) from a hello frame; raises RuntimeError
    (never assert: -O strips those) on anything else."""
    if (
        isinstance(frame, tuple)
        and len(frame) == 3
        and frame[0] == "hello"
        and isinstance(frame[2], dict)
    ):
        return int(frame[1]), dict(frame[2])
    raise RuntimeError(f"bad slave handshake frame {frame!r}")


def main(argv=None):
    """TCP slave process entry — see module docstring."""
    import argparse
    import os

    from repro_torch.core.cluster.codec import WireCodec
    from repro_torch.core.cluster.transport import ShmSlaveEndpoint, TCPSlaveEndpoint

    ap = argparse.ArgumentParser(description="master/slave TCP slave process")
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--transport", default="tcp", choices=["tcp", "shm"],
                    help="wire to the master: a plain TCP socket, or "
                         "shared-memory rings with a TCP control channel "
                         "(co-located masters only)")
    ap.add_argument("--device", type=int, default=-1,
                    help="requested device slot; -1 (default) lets the "
                         "master assign the next free one — what a "
                         "hand-launched remote slave should use")
    ap.add_argument("--slowdown", type=float, default=1.0)
    ap.add_argument("--backend", default="cuda",
                    help="conv backend of this device: cuda (the default: "
                         "the hand-written kernel on the card), torch:cpu, "
                         "numpy or sim")
    ap.add_argument("--wire-dtype", default=None)
    ap.add_argument("--wire-codec", default=None,
                    help="compressor-stack spec, e.g. 'int8' or "
                         "'weights=fp16,acts=fp16,grads=topk:0.05'; "
                         "must match the master's")
    ap.add_argument("--heartbeat-s", type=float, default=0.0,
                    help="send a liveness frame every this many seconds "
                         "(0 = off); masters with a heartbeat deadline "
                         "need it to tell busy from dead")
    ap.add_argument("--auth-env", default="REPRO_CLUSTER_AUTH",
                    help="name of the env var holding the cluster auth "
                         "token (hex); the secret rides the environment, "
                         "never argv (visible in ps)")
    ap.add_argument("--connect-timeout-s", type=float, default=60.0,
                    help="keep retrying the connect for this long — a "
                         "hand-launched slave may legally start before "
                         "the master binds its listener")
    # -- sub-master mode: this process is a whole GROUP -------------------
    ap.add_argument("--group-slowdowns", default=None,
                    help="comma-separated slowdowns of the group's devices "
                         "(first = this sub-master's own compute).  Setting "
                         "this turns the process into a SUB-MASTER: a slave "
                         "to the root on the wire above, a full "
                         "HeteroCluster master to an inner in-proc group")
    ap.add_argument("--group-backends", default=None,
                    help="comma-separated backends of the group's devices "
                         "(default: cuda for all, the card)")
    ap.add_argument("--group-partition", default="auto",
                    help="the INNER per-layer partition axis "
                         "(kernel|spatial|batch|auto)")
    ap.add_argument("--group-microbatches", type=int, default=4)
    ap.add_argument("--group-no-pipeline", action="store_true",
                    help="disable the inner cluster's microbatch pipeline")
    ap.add_argument("--group-bandwidth-mbps", type=float, default=None,
                    help="emulated per-link bandwidth INSIDE the group")
    ap.add_argument("--group-nic-mbps", type=float, default=None,
                    help="emulated shared NIC for the sub-master's own "
                         "in-proc links (see transport.SharedNIC)")
    args = ap.parse_args(argv)
    from repro_torch.core.backends import get_backend

    get_backend(args.backend)  # no card for ``cuda``: raise before joining

    token_hex = os.environ.get(args.auth_env)
    endpoint_cls = (
        ShmSlaveEndpoint if args.transport == "shm" else TCPSlaveEndpoint
    )
    endpoint = endpoint_cls(
        args.host, args.port,
        connect_timeout_s=args.connect_timeout_s,
        auth_token=bytes.fromhex(token_hex) if token_hex else None,
        wire_codec=WireCodec.from_spec(args.wire_codec, args.wire_dtype),
    )
    code = 0
    inner = None
    try:
        extra = None
        if args.group_slowdowns:
            # Lazy on purpose: hierarchy -> cluster pulls the full
            # master-side stack; plain leaf slaves stay numpy-light at
            # import time.
            from repro_torch.core.cluster.hierarchy import (
                GroupSpec,
                build_group_cluster,
                group_hello_meta,
            )

            sds = [float(s) for s in args.group_slowdowns.split(",")]
            bks = (
                args.group_backends.split(",")
                if args.group_backends else None
            )
            inner = build_group_cluster(GroupSpec(
                slowdowns=sds,
                backends=bks,
                partition=args.group_partition,
                pipeline=not args.group_no_pipeline,
                microbatches=args.group_microbatches,
                bandwidth_mbps=args.group_bandwidth_mbps,
                nic_mbps=args.group_nic_mbps,
            ))
            extra = {"group": group_hello_meta(inner)}
        endpoint.send(
            hello_frame(args.device, args.backend, args.slowdown, extra)
        )
        reply = endpoint.recv()
        if (
            not isinstance(reply, tuple) or len(reply) != 2
            or reply[0] != "welcome"
        ):
            raise RuntimeError(f"bad master welcome frame {reply!r}")
        device = int(reply[1])
        if args.heartbeat_s > 0:
            endpoint.start_heartbeat(args.heartbeat_s)
        if inner is not None:
            sub_master_loop(endpoint, inner, device)  # shuts inner down
        else:
            slave_loop(endpoint, args.slowdown, args.backend, device)
    except Exception:  # pragma: no cover - surfaced via the exit code
        traceback.print_exc()
        code = 1
    finally:
        if inner is not None:
            inner.shutdown()  # idempotent; normally done by the loop
        endpoint.close()
        # _exit, not exit: a backend with native runtime threads (a CUDA
        # context) must never hang CPython finalization; a slave has
        # nothing to finalize.
        os._exit(code)


if __name__ == "__main__":
    # Re-enter through the properly-imported module: under ``-m`` this
    # file IS ``__main__``, and a SlaveError pickled from here would
    # unpickle as ``__main__.SlaveError`` on the master (whose __main__
    # is pytest / the CLI) and fail to resolve.
    from repro_torch.core.cluster import protocol as _protocol

    _protocol.main()
