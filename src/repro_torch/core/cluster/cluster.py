"""Algorithms 1 & 2 — the master node and its cluster of slaves.

``HeteroCluster`` is the master (Algorithm 1): it probes every device,
computes the Eq. 1(+comm, +comp-duty) shares, and drives the per-op
scatter/gather halves the schedulers (core/cluster/scheduler.py)
pipeline.  The protocol per convolutional layer (Algorithm 1 lines
6-23): broadcast the inputs, scatter per-device kernel shards (or ship
row strips + halos in spatial mode, or batch-row slices + the
replicated kernel in batch mode), every node convolves its shard —
master included — then gather and reassemble on the master, which also
computes every non-convolutional layer alone.  The backward mirrors
each axis: kernel sums partial dX, spatial overlap-adds strips, batch
sums per-member full dW (an exact all-reduce over disjoint rows).

``transport`` picks the wire:

    "inproc" (default) — every slave is a daemon THREAD, every link an
        ``InProcTransport`` queue pair with optional emulated
        ``bandwidth_mbps`` (the seed behaviour: heterogeneity emulated
        with per-slave slowdown sleeps, links with delivery threads).

    "tcp" — every slave is a real OS PROCESS (spawned with
        ``python -m repro_torch.core.cluster.protocol``) connected back over a
        localhost ``TCPTransport``: comm cost, serialization, and
        slave-side compute are measured, not emulated.  ``probe()``
        additionally measures each link's real bandwidth with an echo
        probe and feeds it to the comm-aware partitioner
        (``bandwidth_mbps`` then only serves as an explicit override for
        the planning terms; nothing is delayed artificially).

    "shm" — tcp's process model, but bulk arrays ride zero-copy
        shared-memory ring buffers (``ShmTransport``); only tiny
        skeleton/control frames cross the socket.  Co-located slaves
        only (the rings are host-local).  Everything else — auth,
        heartbeats, elasticity, byte accounting, bandwidth probing
        (which then times the ring, what the plans will actually see)
        — behaves exactly like tcp.

Heterogeneity is emulated with per-slave *slowdown factors*: after
computing, a slave sleeps (slowdown-1) x the measured compute time,
appearing exactly like a proportionally slower machine to both the
probe and the training loop — in a thread or a subprocess alike.

The cluster is ELASTIC: membership may change while it runs.

* ``expected_slaves=N`` (tcp) skips spawning and waits for N slaves
  launched by hand — on this host or any remote one — via
  ``python -m repro_torch.core.cluster.protocol --host H --port P``; the
  hello handshake brings each joiner's backend/slowdown and the master
  assigns its device slot.  ``listen_host="0.0.0.0"`` opens the
  listener to remote hosts (the REPRO_CLUSTER_AUTH secret must be set
  in BOTH environments — the wire is pickle).
* ``admit()`` grows a running cluster by one slave (a spawned local
  one, or ``spawn=False`` to wait for an external join); ``evict()``
  retires one gracefully.  Either way the next plan re-runs the
  comm-aware Eq. 1 over the new membership.
* ``heartbeat_s`` arms liveness: slaves beat small frames from a side
  thread and the master's reads enforce a deadline, so a crashed OR
  wedged slave raises ``SlaveLost`` within the timeout instead of
  hanging the scheduler.  A lost slave is auto-evicted, every
  in-flight op's missing shard is recomputed BY THE MASTER from the
  plan the op rode (``Pending.plan``/``parts``), and the step drains
  on the survivors with correct numerics — then the next step's plans
  re-partition.  ``failures`` records each loss.
"""
from __future__ import annotations

import hmac
import os
import secrets
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import spans
from repro_torch.core.backends import get_backend, is_tensor, probe_conv_time, seam
from repro_torch.core.cluster import codec, plans, protocol, scheduler
from repro_torch.core.cluster.transport import (
    TRANSPORT_KINDS,
    InProcTransport,
    SharedNIC,
    ShmListener,
    ShmTransport,
    SlaveLost,
    TCPListener,
    TCPTransport,
    Transport,
    _recv_exact,
)
from repro_torch.core.partitioner import allocate_kernels, effective_times


def _np_probe(*, slowdown: float = 1.0, **probe_kwargs) -> float:
    """The paper's §4.1.1 probe on the numpy backend (seed behaviour)."""
    return probe_conv_time("numpy", slowdown=slowdown, **probe_kwargs)


def _probe_flops(probe_kwargs: dict) -> float:
    """The FLOPs of the reference convolution a probe times."""
    return (
        2.0
        * probe_kwargs["batch"]
        * probe_kwargs["image_size"] ** 2
        * probe_kwargs["kernel_size"] ** 2
        * probe_kwargs["in_channels"]
        * probe_kwargs["num_kernels"]
    )


def _src_pythonpath() -> str:
    """The import root of this package, prepended to a slave subprocess's
    PYTHONPATH so ``-m repro_torch.core.cluster.protocol`` resolves without an
    installed wheel (the repo's src/ layout)."""
    here = os.path.abspath(os.path.dirname(__file__))  # .../src/repro_torch/core/cluster
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


class HeteroCluster:
    """The master node (Algorithm 1) plus ``n_slaves`` slaves.

    Device 0 is the master itself (it convolves its own shard while the
    slaves work).  ``slowdowns[i]`` emulates device i's relative speed
    (1.0 = this host's full speed); slowdowns[0] applies to the master.

    ``backends[i]`` names device i's conv backend (core/backends.py);
    defaults to ``cuda`` everywhere, the hand-written kernel on the card
    (no card: the constructor raises).  CPU devices are asked for by
    name: ``numpy``, ``torch:cpu`` or ``sim``.

    ``pipeline=True`` enables the double-buffered microbatch protocol:
    ``conv_forward``/``conv_backward`` split the batch into up to
    ``microbatches`` slices and keep one scatter in flight ahead of every
    gather.  With ``pipeline=False`` (default) every call is a single
    scatter -> compute -> gather barrier, the paper's Algorithm 1.

    ``transport`` is the wire: ``"inproc"`` threads+queues (default) or
    ``"tcp"`` subprocess slaves over real localhost sockets — see the
    module docstring.  ``bandwidth_mbps`` (single float or one value PER
    SLAVE) emulates finite links on inproc; on tcp it only overrides the
    measured planning bandwidth.  Default ``None`` = infinitely fast
    emulated links (inproc) / measure at ``probe()`` (tcp).
    ``master_nic_mbps`` (inproc only) additionally puts ONE emulated
    shared port on the master: traffic on all its links serializes per
    direction through a ``transport.SharedNIC``, modeling the
    master-ingress bottleneck the two-tier hierarchy relieves; planning
    prices each link's fair share (nic/n) unless a per-link value is
    set.

    ``comp_aware=True`` (default) makes the Eq. 1 shares discount the
    master's measured non-conv duty: once ``conv_forward_chain`` or
    ``conv_train_chain`` has observed master-only between/head work
    (``LayerTiming.comp_s`` vs ``master_conv_s``), ``shares_for`` inflates
    the master's probe time by ``1/(1-duty)`` automatically.

    ``probe()`` times the reference convolution once for the cluster.
    A training chain's plans read each layer's own probe instead
    (``layer_probe``): a card's time of a shallow layer is mostly its
    copies, of a deep one mostly its kernel, so one workload's ratio
    mis-splits the other.  There the master is timed where its part of
    the op runs: on tensors on its device where the chain's input lies
    there and the axis computes the master's part on the op's own
    operands, else on numpy operands.  Times set by hand
    (``probe_times = [...]``) are pinned: every plan then splits by
    them.

    ``partition`` picks the conv split axis: ``"kernel"`` (the paper,
    default), ``"spatial"`` (height strips + halo exchange — each slave
    gets only its rows instead of the full activation), or ``"auto"``
    (per layer, the axis with the smaller predicted wall-clock over the
    measured links).  ``wire_dtype`` ("fp16"/"bf16") turns on the
    compact wire codec on any transport; ``wire_codec`` is the full
    compressor stack — a single stage name ("fp16", "int8") for every
    message class, or per-class ``"weights=fp16,acts=int8,
    grads=topk:0.05"`` (top-k applies to gradients only, with
    master-side error feedback).  Pass one or the other, not both.

    ``weight_cache=True`` (default) turns on the versioned
    weight-broadcast cache for the chain drivers and the serve lane:
    slaves cache kernels under a stable per-layer key and the master
    ships a ~24-byte version token instead of re-broadcasting a kernel
    it already shipped — static serve weights cross the wire once per
    slave instead of once per slab.

    Elastic / fault-tolerance knobs (see the module docstring):
    ``expected_slaves`` waits for hand-launched tcp joiners instead of
    spawning; ``listen_host``/``listen_port`` place the tcp listener
    (remote slaves need a routable host and usually a fixed port);
    ``heartbeat_s`` makes spawned slaves beat liveness frames every
    that many seconds and arms the master's read deadline
    (``heartbeat_timeout_s``, default 3x the interval) — tcp only, the
    in-proc queue wire cannot lose a slave silently.  ``admit()`` /
    ``evict()`` change membership at runtime; a slave that dies is
    detected within the deadline, auto-evicted and its in-flight work
    recomputed by the master, and ``failures`` records the event.

    ``clock`` injects the time source behind every master-side deadline
    (joins, heartbeat expiry, shutdown waits) so tests can drive them
    without real waiting; defaults to ``time.monotonic`` and is passed
    through to each ``TCPTransport``.  Emulation sleeps (slowdown /
    bandwidth stretching) intentionally stay on the real clock.
    """

    def __init__(
        self,
        slowdowns: Sequence[float],
        backends: Optional[Sequence[str]] = None,
        *,
        pipeline: bool = False,
        microbatches: int = 4,
        bandwidth_mbps: Union[None, float, Sequence[Optional[float]]] = None,
        comp_aware: bool = True,
        partition: str = "kernel",
        wire_dtype: Optional[str] = None,
        wire_codec: Optional[str] = None,
        weight_cache: bool = True,
        transport: str = "inproc",
        master_nic_mbps: Optional[float] = None,
        expected_slaves: Optional[int] = None,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        heartbeat_s: Optional[float] = None,
        heartbeat_timeout_s: Optional[float] = None,
        join_timeout_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._clock = clock  # first: deadline math below and in helpers uses it
        assert len(slowdowns) >= 1
        if any(sd < 1.0 for sd in slowdowns):
            # the op-level emulation can only SLEEP (slowdown-1)x the
            # measured compute — it cannot make the host faster — so a
            # sub-1 slowdown would probe fast (probe_conv_time scales
            # both directions) yet compute at 1.0x, and Eq. 1 would
            # overfeed the device.  Emulate faster devices with a
            # parameterized sim backend instead.
            raise ValueError(
                f"slowdowns must be >= 1.0 (got {list(slowdowns)}): the "
                f"cluster emulates slower devices by sleeping; for a "
                f"FASTER virtual device use a parameterized sim backend, "
                f"e.g. backends=['sim:5e9', ...]"
            )
        if expected_slaves is not None:
            if transport != "tcp":
                raise ValueError(
                    "expected_slaves waits for external TCP joins; it "
                    "needs transport='tcp'"
                )
            if expected_slaves < 1:
                raise ValueError("expected_slaves must be >= 1")
            if len(slowdowns) != 1 or (backends is not None and len(backends) != 1):
                raise ValueError(
                    "with expected_slaves, pass ONLY the master's "
                    "slowdown/backend — joining slaves bring their own "
                    "in the hello handshake"
                )
        self.slowdowns = list(slowdowns)
        if backends is None:
            backends = ["cuda"] * len(self.slowdowns)
        assert len(backends) == len(self.slowdowns), "one backend per device"
        self.backends = list(backends)
        # resolve every LOCAL name NOW: an unknown backend must raise
        # here, not kill a slave later and leave the master blocked
        # forever.  (External joiners' backends run on THEIR host and
        # are recorded as-is.)
        for name in self.backends:
            get_backend(name)
        self._master_backend = get_backend(self.backends[0])
        # the torch device the master's backend computes on (None: numpy)
        self.master_device = self._master_backend.device
        self.pipeline = bool(pipeline)
        self.microbatches = int(microbatches)
        if partition not in plans.PARTITION_MODES:
            raise ValueError(
                f"partition must be one of {plans.PARTITION_MODES}, "
                f"got {partition!r}"
            )
        self.partition = partition
        # auto's per-layer picks, keyed (x_shape, w_shape), plus the
        # memo that lets repeated serve slabs skip the predictor — both
        # bounded (dynamic batching mints a key per slab batch size) and
        # both invalidated together on any membership change
        self.partition_choices: Dict[tuple, str] = plans.BoundedDict()
        self._mode_cache: Dict[tuple, str] = plans.BoundedDict()
        if wire_codec is not None and wire_dtype is not None:
            raise ValueError(
                "pass wire_codec OR wire_dtype, not both: wire_codec "
                "subsumes the single-dtype knob (wire_codec='fp16' is "
                "the same stack)"
            )
        self.wire_dtype = wire_dtype
        self.wire_codec = wire_codec
        self._wire_np_dtype = codec.resolve_wire_dtype(wire_dtype)
        # the codec TEMPLATE prices the wire for the Eq. 1(+comm) byte
        # predictions; every link gets its own instance from the same
        # spec (top-k error-feedback state is per destination)
        self._codec_cfg = codec.WireCodec.from_spec(wire_codec, wire_dtype)
        self._wire_itemsize = self._codec_cfg.itemsize("acts")
        self._wire_itemsize_w = self._codec_cfg.itemsize("weights")
        self._wire_itemsize_g = self._codec_cfg.itemsize("grads")
        self.weight_cache = bool(weight_cache)
        # versioned weight-broadcast cache, master side: what version of
        # each keyed kernel is current, and which (version, geometry)
        # token each live link last received for it
        self._wstore: Dict[object, Tuple[int, np.ndarray]] = {}
        self._wshipped: Dict[Transport, dict] = {}
        if transport not in TRANSPORT_KINDS:
            raise ValueError(
                f"transport must be one of {TRANSPORT_KINDS}, got {transport!r}"
            )
        self.transport = transport
        if master_nic_mbps is not None and transport != "inproc":
            raise ValueError(
                "master_nic_mbps is bandwidth EMULATION for the in-proc "
                "wire; tcp/shm links share the host's real NIC already"
            )
        self.master_nic_mbps = master_nic_mbps
        self._nic = (
            SharedNIC(master_nic_mbps) if master_nic_mbps is not None else None
        )
        n_cfg = (
            expected_slaves if expected_slaves is not None
            else len(self.slowdowns) - 1
        )
        if bandwidth_mbps is None or isinstance(bandwidth_mbps, (int, float)):
            self.bandwidths: List[Optional[float]] = [bandwidth_mbps] * n_cfg
        else:
            self.bandwidths = list(bandwidth_mbps)
            assert len(self.bandwidths) == n_cfg, "one bandwidth per slave"
        # what the USER pinned, frozen: re-probing on tcp must overwrite
        # stale measurements, never a deliberate override (and never
        # mistake an old measurement for one)
        self._bandwidth_overrides = list(self.bandwidths)
        if heartbeat_s is not None and heartbeat_s <= 0:
            raise ValueError("heartbeat_s must be positive (or None)")
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = (
            heartbeat_timeout_s
            if heartbeat_timeout_s is not None
            else (3.0 * heartbeat_s if heartbeat_s is not None else None)
        )
        self.expected_slaves = expected_slaves
        self.listen_host = listen_host
        self.listen_port = listen_port
        # -- elastic membership: aligned per-slave slots -------------------
        # slot i <-> sockets[i], procs[i], threads[i], slave_ids[i],
        # slowdowns[i+1], backends[i+1], bandwidths[i], measured[i].
        # slave_ids are STABLE (never reused): live plans reference the
        # membership they were built for through them (LayerPlan.member_ids
        # -> _registry), so a plan outlives any eviction.
        self.n_slaves = 0
        self.slave_ids: List[int] = []
        self._next_slave_id = 1
        self._registry: Dict[int, Transport] = {}  # every slave EVER, dead too
        # each member's hello metadata by device id ({} for in-proc
        # threads, which have no handshake): an open dict — sub-masters
        # ride a "group" entry through it without touching the grammar
        self.hello_meta: Dict[int, dict] = {}
        self.sockets: List[Transport] = []
        self.procs: List[Optional[subprocess.Popen]] = []
        self.threads: List[Optional[threading.Thread]] = []
        self.reaped: List[subprocess.Popen] = []  # evicted/killed, waited on
        self.failures: List[dict] = []  # {"device", "t_detected", "error"}
        self.probe_times = None  # the setter turns the per-layer table off
        self.probe_flops: Optional[float] = None  # flops of the probe workload
        self._probe_kwargs: Optional[dict] = None  # last probe() workload
        self.measured_bandwidths: List[Optional[float]] = [None] * n_cfg
        self._listener: Optional[TCPListener] = None
        self._token: Optional[bytes] = None
        self.timing = scheduler.LayerTiming()
        self.comp_aware = bool(comp_aware)
        self.comp_duty = 0.0  # measured master non-conv duty (see shares_for)
        self._duty_mark = (0.0, 0.0)  # (comp_s, master_conv_s) at last update
        self._seq_issued = 0
        self._seq_gathered = 0
        self._shut = False
        if transport in ("tcp", "shm"):
            listener_cls = ShmListener if transport == "shm" else TCPListener
            self._listener = listener_cls(listen_host, listen_port)
            if expected_slaves is None:
                self._token = secrets.token_bytes(self._AUTH_BYTES)
                self._spawn_tcp_slaves()
            else:
                # the join secret comes from the operator's environment —
                # hand-launched (possibly remote) slaves must present the
                # same one, and there is no side channel to hand a
                # generated secret to another terminal/host
                env_tok = os.environ.get("REPRO_CLUSTER_AUTH")
                if not env_tok:
                    self._listener.close()
                    raise RuntimeError(
                        "expected_slaves mode needs the REPRO_CLUSTER_AUTH "
                        "env var set (hex token) in BOTH the master's and "
                        "every slave's environment: the wire is pickle, "
                        "and an unauthenticated listener would hand any "
                        "process that can reach it code execution here.  "
                        "Generate one with: python -c 'import secrets; "
                        "print(secrets.token_hex(32))'"
                    )
                self._token = bytes.fromhex(env_tok)
                if len(self._token) != self._AUTH_BYTES:
                    self._listener.close()
                    raise RuntimeError(
                        f"REPRO_CLUSTER_AUTH must be {self._AUTH_BYTES} "
                        f"bytes ({2 * self._AUTH_BYTES} hex chars), got "
                        f"{len(self._token)} bytes"
                    )
                try:
                    self._await_tcp_joins(expected_slaves, join_timeout_s)
                except Exception:
                    # failed startup must not leak the listener or the
                    # links of slaves that DID join (EOF tells them to
                    # exit; their operators own the processes)
                    for s in self.sockets:
                        s.close()
                    self._listener.close()
                    raise
        else:
            for sd, bk, bw in zip(
                self.slowdowns[1:], self.backends[1:], self.bandwidths
            ):
                self._start_inproc_slave(sd, bk, bw)
            self._apply_nic_planning()

    # -- membership plumbing: slots, spawn, accept, join -------------------
    _AUTH_BYTES = 32

    def _add_slot(
        self,
        dev: int,
        sock: Transport,
        proc: Optional[subprocess.Popen],
        thread: Optional[threading.Thread],
    ) -> None:
        """Append one live slave slot; every aligned list grows by one."""
        self.slave_ids.append(dev)
        self._registry[dev] = sock
        self.sockets.append(sock)
        self.procs.append(proc)
        self.threads.append(thread)
        self.n_slaves = len(self.sockets)

    def _link_codec(self) -> codec.WireCodec:
        """A fresh codec instance for ONE link — never shared: top-k
        error-feedback residuals accumulate per destination."""
        return codec.WireCodec.from_spec(self.wire_codec, self.wire_dtype)

    def _start_inproc_slave(
        self, slowdown: float, backend: str, bandwidth: Optional[float]
    ) -> int:
        """Start one in-proc slave thread on a fresh link and return its
        device id — a seam subclasses override (the hierarchy starts a
        sub-master thread over a whole inner cluster here instead)."""
        link = InProcTransport(
            bandwidth, self._wire_np_dtype, wire_codec=self._link_codec(),
            nic=self._nic,
        )
        dev = self._next_slave_id
        self._next_slave_id += 1
        t = threading.Thread(
            target=protocol.slave_loop,
            args=(link.slave_endpoint(), slowdown, backend, dev),
            daemon=True,
        )
        t.start()
        self._add_slot(dev, link, None, t)
        self.hello_meta[dev] = {}
        return dev

    def _apply_nic_planning(self) -> None:
        """Fold the shared master NIC into the PLANNING bandwidths: with
        one emulated port serialized across n links, each link's fair
        steady-state share is nic/n — the static approximation Eq. 1
        prices (per-message serialization is runtime emulation, not
        plannable).  Explicit per-link overrides win (a link can be
        narrower than its NIC share); no-op without a NIC."""
        if self._nic is None or self.n_slaves == 0:
            return
        share = self._nic.bandwidth_mbps / self.n_slaves
        self.bandwidths = [
            ovr if ovr is not None else share
            for ovr in self._bandwidth_overrides
        ]

    def _slave_env(self) -> dict:
        """Environment for a spawned slave process: the src/ import root
        and the per-cluster auth secret (env, not argv — argv shows in
        ps)."""
        env = os.environ.copy()
        src = _src_pythonpath()
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        env["REPRO_CLUSTER_AUTH"] = self._token.hex()
        return env

    def _slave_cmd(self, dev: int, slowdown: float, backend: str) -> list:
        """The argv a spawned slave process runs — a seam subclasses
        extend (the hierarchy appends ``--group-*`` flags to turn the
        process into a sub-master).  The auth token is NOT here: it
        rides the environment (argv shows in ps)."""
        # a listener bound to the wildcard interface is not a connect
        # target; local spawns dial loopback
        host = (
            "127.0.0.1" if self._listener.host == "0.0.0.0"
            else self._listener.host
        )
        cmd = [
            sys.executable, "-m", "repro_torch.core.cluster.protocol",
            "--host", host,
            "--port", str(self._listener.port),
            "--device", str(dev),
            "--slowdown", str(slowdown),
            "--backend", backend,
        ]
        if self.transport == "shm":
            cmd += ["--transport", "shm"]
        if self.wire_dtype is not None:
            cmd += ["--wire-dtype", self.wire_dtype]
        if self.wire_codec is not None:
            cmd += ["--wire-codec", self.wire_codec]
        if self.heartbeat_s is not None:
            cmd += ["--heartbeat-s", str(self.heartbeat_s)]
        return cmd

    def _spawn_slave_proc(
        self, dev: int, slowdown: float, backend: str, env: dict
    ) -> subprocess.Popen:
        return subprocess.Popen(
            self._slave_cmd(dev, slowdown, backend), env=env
        )

    def _accept_slave(self, timeout_s: float) -> Tuple[TCPTransport, int, dict]:
        """Accept + authenticate + handshake ONE joining slave, skipping
        over junk connections.

        Connections are AUTHENTICATED before anything is unpickled: the
        joiner must present the per-cluster token as its first raw
        bytes.  The wire is pickle, so an unauthenticated listener
        would hand any process that can reach it arbitrary code
        execution in the master.  A connection that fails the handshake
        — no/wrong token, EOF, silence, garbled hello — is closed and
        REJECTED, and the accept loop keeps waiting for a real slave
        until ``timeout_s`` runs out: on an exposed listener a port
        scanner or health check must never abort cluster startup.  The
        hello frame carries the requested device slot (-1 = assign one)
        and the joiner's backend/slowdown metadata; the master replies
        ("welcome", dev) — it owns device numbering, and ids are never
        reused so live plans can keep naming dead members."""
        deadline = self._clock() + timeout_s
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                raise TimeoutError(
                    f"no valid slave joined within {timeout_s:.0f}s"
                )
            conn = self._listener.accept(timeout_s=remaining)
            conn.settimeout(10.0)  # a silent stranger must not hang us
            chan: Optional[TCPTransport] = None
            try:
                presented = _recv_exact(conn, self._AUTH_BYTES)
                if not hmac.compare_digest(presented, self._token):
                    raise RuntimeError(
                        "connection did not present the cluster auth "
                        "token (stray process, or REPRO_CLUSTER_AUTH "
                        "mismatch?)"
                    )
                # the 10s timeout stays armed through the hello so a
                # peer that authenticates then stalls cannot hang us
                chan_cls = (
                    ShmTransport if self.transport == "shm" else TCPTransport
                )
                chan = chan_cls(
                    conn, self._wire_np_dtype,
                    heartbeat_timeout_s=self.heartbeat_timeout_s,
                    clock=self._clock,
                    wire_codec=self._link_codec(),
                )
                requested, meta = protocol.parse_hello(chan.read_on_master())
            except (OSError, EOFError, RuntimeError) as e:
                if chan is not None:
                    chan.close()
                else:
                    conn.close()
                print(
                    f"[hetero] rejected a connection on the cluster "
                    f"listener: {e}",
                    file=sys.stderr, flush=True,
                )
                continue
            conn.settimeout(None)  # ops block indefinitely from here on
            if requested >= 1 and requested not in self._registry:
                dev = requested
                self._next_slave_id = max(self._next_slave_id, dev + 1)
            else:
                dev = self._next_slave_id
                self._next_slave_id += 1
            chan.write_to_slave(("welcome", dev))
            return chan, dev, meta

    def _spawn_tcp_slaves(self) -> None:
        """Spawn one OS process per configured slave, accept their
        connections back, and register the channels in device order
        (accept order is whoever wins the connect race; the hello
        handshake re-sorts)."""
        env = self._slave_env()
        pending: Dict[int, subprocess.Popen] = {}
        for sd, bk in zip(self.slowdowns[1:], self.backends[1:]):
            dev = self._next_slave_id
            self._next_slave_id += 1
            pending[dev] = self._spawn_slave_proc(dev, sd, bk, env)
        by_device: Dict[int, TCPTransport] = {}
        metas: Dict[int, dict] = {}
        try:
            for _ in range(len(pending)):
                chan, dev, meta = self._accept_slave(timeout_s=60.0)
                # RuntimeError, not assert: -O must not let a malformed
                # handshake mispair device channels
                if dev not in pending or dev in by_device:
                    raise RuntimeError(
                        f"unexpected device id {dev} in spawn handshake "
                        f"(expected one of {sorted(pending)})"
                    )
                by_device[dev] = chan
                metas[dev] = meta
        except Exception:
            for p in pending.values():
                p.kill()
            self._listener.close()
            raise
        for dev in sorted(by_device):
            by_device[dev].reset_counters()  # handshake isn't protocol traffic
            self._add_slot(dev, by_device[dev], pending[dev], None)
            self.hello_meta[dev] = metas[dev]

    def _await_tcp_joins(self, n: int, timeout_s: float) -> None:
        """Wait for ``n`` hand-launched slaves to join the listener —
        the remote-host path.  Each joiner's backend/slowdown come from
        its hello metadata; the wait is announced on stderr so the
        operator knows where to point the slaves."""
        print(
            f"[hetero] waiting for {n} slave(s) on "
            f"{self._listener.host}:{self._listener.port} "
            f"(auth: REPRO_CLUSTER_AUTH)",
            file=sys.stderr, flush=True,
        )
        deadline = self._clock() + timeout_s
        for _ in range(n):
            chan, dev, meta = self._accept_slave(
                timeout_s=max(1.0, deadline - self._clock())
            )
            self.slowdowns.append(float(meta.get("slowdown", 1.0)))
            self.backends.append(str(meta.get("backend", "cuda")))
            chan.reset_counters()
            self._add_slot(dev, chan, None, None)
            self.hello_meta[dev] = meta
            print(
                f"[hetero] slave {dev} joined "
                f"(backend={self.backends[-1]}, "
                f"slowdown={self.slowdowns[-1]})",
                file=sys.stderr, flush=True,
            )

    # -- elastic membership: admit / evict / loss --------------------------
    @property
    def auth_token_hex(self) -> Optional[str]:
        """The cluster's join secret (hex), for handing to a slave an
        operator launches AFTER the cluster came up (``admit(
        spawn=False)``): export it as REPRO_CLUSTER_AUTH in the slave's
        environment.  None on the in-proc transport (no listener)."""
        return self._token.hex() if self._token is not None else None

    @property
    def listen_address(self) -> Optional[Tuple[str, int]]:
        """(host, port) a joining slave should dial, or None (inproc)."""
        if self._listener is None:
            return None
        return self._listener.host, self._listener.port

    def admit(
        self,
        slowdown: float = 1.0,
        backend: str = "cuda",
        *,
        bandwidth_mbps: Optional[float] = None,
        spawn: bool = True,
        timeout_s: float = 120.0,
        probe_time: Optional[float] = None,
    ) -> int:
        """Grow the running cluster by one slave and fold it into the
        next plan's comm-aware Eq. 1 split.  Returns the new device id.

        ``spawn=True`` starts it here: a slave thread (inproc) or a
        local subprocess (tcp) with the given slowdown/backend.
        ``spawn=False`` (tcp only) WAITS for an external join — a slave
        someone launched by hand via ``python -m
        repro_torch.core.cluster.protocol`` on any reachable host; its
        backend/slowdown come from the hello handshake.

        If the cluster has probe times, the newcomer is probed with the
        same workload (or takes the explicit ``probe_time`` — pass one
        when ``probe_times`` were pinned by hand, as the benches do,
        so the synthetic scale stays consistent); on tcp its link
        bandwidth is measured.  In-flight plans are untouched — they
        bind the old membership — and ``partition_choices`` is cleared
        so auto re-resolves per layer."""
        if self._shut:
            raise RuntimeError("cluster is shut down")
        if slowdown < 1.0 and spawn:
            raise ValueError("slowdowns must be >= 1.0 (see __init__)")
        if self.transport == "inproc":
            if not spawn:
                raise ValueError(
                    "inproc slaves are threads in this process; external "
                    "joins (spawn=False) need transport='tcp'"
                )
            get_backend(backend)  # fail here, not in the slave thread
            self._start_inproc_slave(slowdown, backend, bandwidth_mbps)
            self.slowdowns.append(slowdown)
            self.backends.append(backend)
        else:
            dev_hint = None
            if spawn:
                get_backend(backend)
                dev_hint = self._next_slave_id
                self._next_slave_id += 1
                proc = self._spawn_slave_proc(
                    dev_hint, slowdown, backend, self._slave_env()
                )
            else:
                proc = None
            try:
                chan, dev, meta = self._accept_slave(timeout_s=timeout_s)
            except Exception:
                # never leak the just-spawned process on a failed accept
                # (it holds the auth token and would retry forever)
                if proc is not None:
                    proc.kill()
                    proc.wait(timeout=5)
                raise
            if spawn and dev != dev_hint:
                # an external joiner won the accept race: keep IT (its
                # hello metadata applies) and abort our spawn attempt —
                # pairing our Popen with a stranger's channel would make
                # a later evict kill the wrong process
                proc.kill()
                proc.wait(timeout=5)
                proc = None
                spawn = False
            if not spawn:
                slowdown = float(meta.get("slowdown", 1.0))
                backend = str(meta.get("backend", "cuda"))
            chan.reset_counters()
            self.slowdowns.append(slowdown)
            self.backends.append(backend)
            self._add_slot(dev, chan, proc, None)
            self.hello_meta[dev] = meta
        self.bandwidths.append(bandwidth_mbps)
        self._bandwidth_overrides.append(bandwidth_mbps)
        self.measured_bandwidths.append(None)
        self._apply_nic_planning()
        sock, dev = self.sockets[-1], self.slave_ids[-1]
        if self.transport in ("tcp", "shm"):
            try:
                meas = sock.measure_bandwidth_mbps()
            except SlaveLost as e:
                self._on_slave_lost(sock, e)
                raise
            self.measured_bandwidths[-1] = meas
            if self._bandwidth_overrides[-1] is None:
                self.bandwidths[-1] = meas
        if self.probe_times is not None:
            if probe_time is None:
                kw = self._probe_kwargs or dict(
                    image_size=16, in_channels=3, kernel_size=3,
                    num_kernels=8, batch=4, repeats=1,
                )
                try:
                    sock.write_to_slave(("probe", kw))
                    probe_time = self._check_result(sock.read_on_master())
                except SlaveLost as e:
                    self._on_slave_lost(sock, e)
                    raise
            self.probe_times.append(float(probe_time))
        self.partition_choices.clear()
        self._mode_cache.clear()
        return dev

    def evict(self, device: int) -> None:
        """Gracefully retire slave ``device`` (its stable id): it is
        told to exit, reaped, and removed from membership; the next
        plan re-runs the comm-aware Eq. 1 over the survivors.  Plans
        already in flight keep naming it and the master absorbs its
        shards — an evict mid-step is safe, just not free."""
        if device not in self.slave_ids:
            raise KeyError(
                f"no live slave with device id {device}; live: "
                f"{self.slave_ids}"
            )
        pos = self.slave_ids.index(device)
        sock = self.sockets[pos]
        try:
            sock.write_to_slave(protocol.TRAIN_OVER)
        except RuntimeError:  # link already down; remove it anyway
            pass
        self._remove_slot(pos, kill=False)

    def _remove_slot(self, pos: int, *, kill: bool) -> None:
        """Drop slot ``pos`` from every aligned membership list and its
        column from the per-layer probe table.  The socket is marked
        lost FIRST so any plan that still names this member routes its
        shards to the master's recovery path."""
        sock = self.sockets[pos]
        for col in (self._layer_times or {}).values():
            col.pop(self.slave_ids[pos], None)
        sock.lost = True
        proc, thread = self.procs[pos], self.threads[pos]
        if kill and proc is not None:
            proc.kill()
        if thread is not None:
            thread.join(timeout=10)
        if proc is not None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover - stuck exit
                proc.kill()
                proc.wait(timeout=5)
            self.reaped.append(proc)
        sock.close()
        self._wshipped.pop(sock, None)  # its weight-cache tokens die with it
        had = self.n_slaves
        for lst in (
            self.slave_ids, self.sockets, self.procs, self.threads,
            self.measured_bandwidths,
        ):
            del lst[pos]
        del self.slowdowns[pos + 1]
        del self.backends[pos + 1]
        del self.bandwidths[pos]
        del self._bandwidth_overrides[pos]
        if self.probe_times is not None and len(self.probe_times) == had + 1:
            del self.probe_times[pos + 1]
        self.n_slaves = len(self.sockets)
        self._apply_nic_planning()
        self.partition_choices.clear()
        self._mode_cache.clear()

    def _on_slave_lost(self, sock: Transport, err: BaseException) -> None:
        """A link reported its slave dead: record the failure, kill any
        local process remnant, and auto-evict the slot.  Idempotent —
        a slave's loss may surface on several reads."""
        sock.lost = True
        if sock not in self.sockets:
            return  # already evicted
        pos = self.sockets.index(sock)
        self.failures.append({
            "device": self.slave_ids[pos],
            "t_detected": self._clock(),
            "error": str(err),
        })
        self._remove_slot(pos, kill=True)

    def _plan_sockets(self, plan: plans.LayerPlan) -> List[Transport]:
        """The participant links of a plan, in plan order — resolved
        through the stable-id registry so a plan built before an
        evict/admit still addresses exactly the members it split for."""
        if plan.member_ids is None:
            return list(self.sockets)
        return [self._registry[d] for d in plan.member_ids]

    # -- §4.1.1 pre-processing -------------------------------------------
    @property
    def probe_times(self) -> Optional[List[float]]:
        """Each device's time of the cluster-wide reference convolution,
        in device order: measured by ``probe()``, or set by hand.  Times
        set by hand are pinned: every plan then splits by them, and no
        layer is probed on its own (``layer_probe``)."""
        return self._probe_times

    @probe_times.setter
    def probe_times(self, times: Optional[List[float]]) -> None:
        """Pin the times: the per-layer table goes off."""
        self._probe_times = times
        # per layer placement and geometry ("card" or "host", then the
        # probe's kwargs as a sorted tuple): each member's time by device
        # id (0 = the master); None = pinned
        self._layer_times: Optional[Dict[tuple, Dict[int, float]]] = None

    def probe(self, **probe_kwargs) -> List[float]:
        """Every device runs the timed reference convolution on its OWN
        backend — sequential so the 1-core host's timings do not
        interfere.  Also records the probe workload's FLOPs (the scale
        factor that lets the comm-aware partitioner and the auto axis
        chooser turn probe times into absolute per-layer predictions)
        and, on the tcp transport, each link's measured round-trip
        bandwidth — the real wire feeds ``link_aware_times`` instead of
        the ``bandwidth_mbps`` knob.  A slave lost mid-probe is
        auto-evicted and the times cover the survivors."""
        master_t = probe_conv_time(
            self._master_backend, slowdown=self.slowdowns[0], **probe_kwargs
        )
        slave_ts: Dict[Transport, float] = {}
        for s in list(self.sockets):
            try:
                s.write_to_slave(("probe", probe_kwargs))
                slave_ts[s] = self._check_result(s.read_on_master())
            except SlaveLost as e:
                self._on_slave_lost(s, e)
        if self.transport in ("tcp", "shm"):
            measured: Dict[Transport, Optional[float]] = {}
            for s in list(self.sockets):
                try:
                    measured[s] = s.measure_bandwidth_mbps()
                except SlaveLost as e:
                    self._on_slave_lost(s, e)
            self.measured_bandwidths = [measured.get(s) for s in self.sockets]
            # an explicit constructor bandwidth_mbps stays an override for
            # planning; otherwise every probe() refreshes the measurement
            self.bandwidths = [
                ovr if ovr is not None else meas
                for ovr, meas in zip(
                    self._bandwidth_overrides, self.measured_bandwidths
                )
            ]
        self._probe_times = [master_t] + [
            slave_ts[s] for s in self.sockets if s in slave_ts
        ]
        self._layer_times = {}  # measured anew: every layer is probed anew
        self.probe_flops = _probe_flops(probe_kwargs)
        self._probe_kwargs = dict(probe_kwargs)
        return self.probe_times

    def _layer_probe_kwargs(self, x, w_shape) -> Tuple[dict, tuple]:
        """The reference convolution at one call's geometry (``x`` of
        shape ``(rows, H, W, Cin)``, ``w_shape`` ``(kh, kw, Cin, Cout)``)
        with the repeats and seed ``probe()`` ran, and its key in the
        table: where the master's part of the op on ``x`` runs, then the
        geometry, so a card-path and a host-path chain on one cluster
        keep columns of their own.  ``"card"`` where ``x`` is a tensor
        on the master's device and the axis computes the master's part
        on the op's own operands (the kernel axis); else ``"host"``
        (numpy operands; the spatial and batch axes, and ``"auto"``,
        whose pick would need a time for each placement)."""
        ax = plans.AXES.get(self.partition)
        on_card = self._card(x) is not None and ax is not None and ax.card
        kw = dict(
            image_size=int(x.shape[1]), in_channels=int(x.shape[3]),
            kernel_size=int(w_shape[0]), num_kernels=int(w_shape[3]),
            batch=int(x.shape[0]),
        )
        for k in ("repeats", "seed"):
            if k in self._probe_kwargs:
                kw[k] = self._probe_kwargs[k]
        return kw, ("card" if on_card else "host",) + tuple(sorted(kw.items()))

    def layer_probe_due(self, x, w_shape) -> bool:
        """Whether ``layer_probe`` would probe a device for this layer:
        the table is on (``probe()`` measured the times, more than one
        device) and lacks a member's time for the placement and
        geometry."""
        if self._layer_times is None or self.n_slaves == 0:
            return False
        _, key = self._layer_probe_kwargs(x, w_shape)
        col = self._layer_times.get(key, {})
        return any(dev not in col for dev in [0] + self.slave_ids)

    def layer_probe(self, x, w_shape) -> Optional[plans.LayerProbe]:
        """A training plan's Eq. 1 input for one conv layer: each
        device's time of the §4.1.1 reference convolution at THIS
        layer's geometry (one call's input ``x``, the layer's
        ``w_shape``), in device order, and its FLOPs.  One device's
        ratio to another's depends on the layer (a card's time of a
        shallow layer is mostly copies, of a deep one mostly its
        kernel), so the cluster-wide probe would mis-split most layers.

        A member missing from the table for this placement and geometry
        is probed now, one device after another, and kept: later plans
        of the placement and geometry read the table.  A slave runs the
        ``probe`` op; the master runs it on its own backend where its
        part of the op on ``x`` will run: on tensors on its device on
        the card path's kernel axis, which cross no seam while timed,
        else on numpy operands.  Each probe is the span
        ``cluster.layer_probe`` with the label ``operands`` (``"card"``
        or ``"host"``; a slave's ``"host"``: the wire hands it numpy).
        None where the cluster-wide probe stays the input: times pinned
        by hand, never probed, or no slave.

        Raises:
            RuntimeError: ops are in flight — a probe's answer would
                come back behind their results on the FIFO links.
        """
        if self._layer_times is None or self.n_slaves == 0:
            return None
        kw, key = self._layer_probe_kwargs(x, w_shape)
        col = self._layer_times.setdefault(key, {})
        missing = [dev for dev in [0] + self.slave_ids if dev not in col]
        if missing and self._seq_issued != self._seq_gathered:
            raise RuntimeError(
                "a layer probe needs idle links: gather the ops in flight "
                f"(issued {self._seq_issued}, gathered {self._seq_gathered})"
            )
        geometry = {k: kw[k] for k in (
            "image_size", "in_channels", "kernel_size", "num_kernels", "batch"
        )}
        for dev in missing:
            t0 = time.perf_counter()
            where = "host"
            if dev == 0:
                backend, where = self.backends[0], key[0]
                col[0] = probe_conv_time(
                    self._master_backend, slowdown=self.slowdowns[0],
                    device=self.master_device if where == "card" else None, **kw
                )
            else:
                if dev not in self.slave_ids:
                    continue  # lost while an earlier member was probed
                pos = self.slave_ids.index(dev)
                sock, backend = self.sockets[pos], self.backends[pos + 1]
                try:
                    sock.write_to_slave(("probe", kw))
                    col[dev] = self._check_result(sock.read_on_master())
                except SlaveLost as e:
                    self._on_slave_lost(sock, e)
                    continue
            spans.record("cluster.layer_probe", t0, time.perf_counter(),
                         device=dev, backend=backend, operands=where, **geometry)
        return plans.LayerProbe(
            [col[0]] + [col[dev] for dev in self.slave_ids], _probe_flops(kw)
        )

    def _effective_times(
        self, layer: Optional[plans.LayerProbe] = None
    ) -> List[float]:
        """Probe times (the layer's own where ``layer`` is given) with
        the comp-aware master discount applied."""
        if layer is None:
            assert self.probe_times is not None, "run probe() first"
        times = self.probe_times if layer is None else layer.times
        if self.comp_aware and self.comp_duty > 0.0:
            times = effective_times(
                times, comp_duties={0: self.comp_duty}
            )
        return list(times)

    def shares_for(
        self,
        num_kernels: int,
        *,
        unit_bytes: float = 0.0,
        layer_flops: Optional[float] = None,
        layer: Optional[plans.LayerProbe] = None,
    ) -> np.ndarray:
        """Eq. 1 unit counts (kernels or rows) from the probe times — the
        cluster-wide probe's, or ``layer``'s (``layer_probe``); with
        ``comp_aware`` the master's measured non-conv duty discounts its
        share.  When the layer's wire cost is known (``unit_bytes`` per
        unit, ``layer_flops`` to scale probe times to this layer) and the
        links are finite, each slave's comm term joins its compute term —
        the comm-extended Eq. 1 (partitioner.effective_times)."""
        times = self._effective_times(layer)
        probe_flops = self.probe_flops if layer is None else layer.flops
        if (
            unit_bytes > 0.0
            and layer_flops
            and probe_flops
            and any(bw is not None for bw in self.bandwidths)
        ):
            scale = layer_flops / probe_flops
            wire = [0.0] + [
                float(num_kernels) * unit_bytes if bw is not None else 0.0
                for bw in self.bandwidths
            ]
            times = effective_times(
                [t * scale for t in times],
                wire_bytes=wire,
                bandwidths_mbps=[None] + list(self.bandwidths),
            )
        return allocate_kernels(num_kernels, times)

    def _update_comp_duty(self):
        """Refresh the measured non-conv duty — the fraction of the
        master's busy time spent OUTSIDE its conv shard — from the window
        since the LAST update (deltas, not cumulative): a one-off cost in
        an early step (jit compilation of the master-only stages, cold
        caches) then mis-shapes at most the next step's shares before the
        first clean window corrects it."""
        t = self.timing
        dc = t.comp_s - self._duty_mark[0]
        dm = t.master_conv_s - self._duty_mark[1]
        self._duty_mark = (t.comp_s, t.master_conv_s)
        if dc + dm > 0.0:
            self.comp_duty = dc / (dc + dm)

    # -- partition planning (core/cluster/plans.py) -----------------------
    def _unit_bytes(self, x_shape, w_shape, mode: str, op: str) -> float:
        return plans.unit_bytes(
            x_shape, w_shape, mode, op, self._wire_itemsize,
            w_itemsize=self._wire_itemsize_w,
            g_itemsize=self._wire_itemsize_g,
        )

    # -- versioned weight-broadcast cache ---------------------------------
    def _weight_version(self, key, w: np.ndarray) -> Tuple[int, bool]:
        """The cache version of kernel ``w`` under ``key``, and whether
        the slaves may already hold it.  Identity, not equality: the
        serve lane holds one kernel OBJECT across every request (hit),
        a training loop makes a new array each step (miss + bump) —
        and an elementwise compare of every kernel every microbatch
        would eat the bytes the cache saves."""
        cur = self._wstore.get(key)
        if cur is not None and cur[1] is w:
            return cur[0], True
        version = cur[0] + 1 if cur is not None else 0
        self._wstore[key] = (version, w)
        return version, False

    def _wire_weights(
        self, sock: Transport, plan: plans.LayerPlan, pos: int,
        shard: Optional[np.ndarray], send_weights: bool,
    ):
        """The weight slot for plan position ``pos``'s scatter to
        ``sock``.  Legacy path (no ``plan.wkey``): the raw shard, or
        ``None`` for "reuse your per-op cache".  Versioned path: a
        ``WeightRef`` — bare token when this link already received this
        exact (version, geometry, position), kernel attached otherwise,
        so an unchanged serve kernel crosses each link once.  A shard on
        the master's device crosses to the host only where it ships."""
        if plan.wkey is None:
            return seam(None, "cluster.to_host", w=shard) if send_weights else None
        token = (
            plan.wversion, plan.mode,
            tuple(int(c) for c in plan.counts), pos,
        )
        shipped = self._wshipped.setdefault(sock, {})
        if shipped.get(plan.wkey) == token:
            return codec.WeightRef(plan.wkey, plan.wversion, None)
        shipped[plan.wkey] = token
        return codec.WeightRef(plan.wkey, plan.wversion,
                               seam(None, "cluster.to_host", w=shard))

    def predict_partition_seconds(
        self, x_shape, w_shape, op: str = "conv"
    ) -> Dict[str, float]:
        """Predicted wall-clock per partition mode for one layer —
        the Eq. 1(+comm) model over this cluster's probe times and
        link bandwidths (see ``plans.predict_partition_seconds``).

        Args:
            x_shape: input activation shape ``(B, H, W, Cin)``.
            w_shape: kernel shape ``(kh, kw, Cin, Cout)``.
            op: ``"conv"`` | ``"bwd"`` | ``"train"`` — which sweep(s)
                the prediction weighs.

        Returns:
            dict mode -> predicted seconds, for every eligible mode.
        """
        return plans.predict_partition_seconds(self, x_shape, w_shape, op)

    def _resolve_mode(
        self, x_shape, w_shape, override: Optional[str], op: str = "conv"
    ) -> str:
        return plans.resolve_mode(self, x_shape, w_shape, override, op)

    def plan_conv(
        self, x_shape, w: np.ndarray, op: str = "conv",
        partition: Optional[str] = None, weight_key=None,
    ) -> plans.LayerPlan:
        """Build the partition plan one conv layer rides: resolve the
        split axis, cut the Eq. 1(+comm) shares over the CURRENT
        membership, and pre-split kernels/rows/halos.

        Args:
            x_shape: input activation shape ``(B, H, W, Cin)``.
            w: the layer's full kernel ``(kh, kw, Cin, Cout)``.
            op: ``"conv"`` | ``"bwd"`` | ``"train"`` — what the plan
                will be used for (weighs the auto-axis choice).
            partition: per-call override of the cluster's axis
                (``"kernel"`` | ``"spatial"`` | ``"batch"`` |
                ``"auto"``).
            weight_key: stable key opting this layer into the
                versioned weight-broadcast cache (None = legacy
                per-op caching only).

        Returns:
            A ``plans.LayerPlan`` naming members by stable slave id.
        """
        return plans.plan_conv(self, x_shape, w, op, partition, weight_key)

    # -- async scatter/gather halves -------------------------------------
    def _split(self, w: np.ndarray, counts: np.ndarray) -> List[np.ndarray]:
        return plans.split_kernels(w, counts)

    def scatter_conv(
        self, x: np.ndarray, w: np.ndarray, *, partition: Optional[str] = None
    ) -> scheduler.Pending:
        """Scatter one conv: broadcast x + kernel shards (kernel mode),
        height strips + the full kernel (spatial mode), or batch-row
        slices + the replicated kernel (batch mode); returns a handle.
        The master's own shard runs at gather time."""
        x = np.asarray(x, np.float32)
        plan = self.plan_conv(x.shape, w, "conv", partition)
        return self._scatter_conv_planned(x, plan, send_weights=True)

    def _write_op(self, sock, msg) -> None:
        """One scatter write; a link that died under the write is folded
        into the loss path (its shard will be recomputed at the gather)
        instead of aborting the step."""
        if sock.lost:
            return
        try:
            sock.write_to_slave(msg)
        except SlaveLost as e:
            self._on_slave_lost(sock, e)

    # -- the card path: the master's operands on its own device ----------
    def _card(self, x):
        """The master's device where ``x`` is a tensor on it (the card
        path), else None (the host path)."""
        d = self.master_device
        return d if d is not None and is_tensor(x) and x.device == d else None

    def _operand(self, a):
        """``a`` as the cluster's ops take it: a float32 tensor on the
        master's device, made contiguous once here, before any backend
        call (the card path); else a float32 numpy array."""
        if self._card(a) is not None:
            return a.float().contiguous()
        return np.asarray(a, np.float32)

    def _slave_x(self, x, plan: plans.LayerPlan, x_host):
        """The input an op hands its slaves: ``x`` itself on the host
        path.  On the card path x's host copy: the forward's
        (``x_host``) where given, else made here (the span
        ``cluster.to_host``) where a slave holds kernels, else a
        zero-stride stand-in of x's shape (a slave without kernels reads
        only the shape)."""
        if not is_tensor(x):
            return x
        if x_host is not None:
            return x_host
        if np.any(np.asarray(plan.counts)[1:]):
            return seam(None, "cluster.to_host", x=x)
        return np.broadcast_to(np.zeros((), np.float32), tuple(x.shape))

    def _scatter_conv_planned(
        self, x: np.ndarray, plan: plans.LayerPlan, send_weights: bool,
        x_host=None,
    ) -> scheduler.Pending:
        """The op's scatter; ``send_weights=False`` sends w=None: the
        slave reuses its cached kernel, so pipelined microbatches pay the
        weight traffic once.  With ``x`` a tensor on the master's device
        (the card path), an axis whose master computes on the card
        (``plans.axis(plan).card``) keeps x there and hands the slaves
        its host copy; the other axes run their host path on that copy,
        and their gather hands back a tensor.  ``x_host``: the host copy
        an earlier op of the same input made (the backward reuses the
        forward's)."""
        return self._scatter("conv", x, None, plan, send_weights, x_host)

    def gather_conv(self, p: scheduler.Pending) -> np.ndarray:
        """Compute the master's part, collect the slaves' feature maps
        (FIFO: gathers must be issued in scatter order) and put them
        together by the axis rule: along channels (kernel axis), height
        (spatial strips) or the N axis (batch rows).  A participant lost
        since the scatter contributes via the master's recovery compute
        instead of the wire.  On the card path the result lies on the
        master's device: where the master computed its part there, each
        slave's part is brought there and joined there."""
        rule, ys = self._gather(p, "conv")
        if rule.card:
            ys[1:] = [seam(p.device, "cluster.to_card", y=y) for y in ys[1:]]
            return rule.assemble(p.plan, "conv", ys, p.x)
        return seam(p.device, "cluster.to_card", y=rule.assemble(p.plan, "conv", ys, p.x))

    def scatter_bwd(
        self, x: np.ndarray, w: np.ndarray, g: np.ndarray,
        *, partition: Optional[str] = None,
    ) -> scheduler.Pending:
        """Issue the backward (VJP) halves: plan, ship each member its
        input + kernel shard + grad slice, defer the master's own
        shard.  Pair with ``gather_bwd``.

        Args:
            x: the layer's forward input ``(B, H, W, Cin)``.
            w: the layer's full kernel.
            g: upstream gradient wrt the layer output.
            partition: per-call partition-axis override.

        Returns:
            The in-flight ``Pending`` (op ``"bwd"``) to gather.
        """
        x = np.asarray(x, np.float32)
        g = np.asarray(g, np.float32)
        plan = self.plan_conv(x.shape, w, "bwd", partition)
        return self._scatter_bwd_planned(x, plan, g, send_weights=True)

    def _scatter_bwd_planned(
        self, x: np.ndarray, plan: plans.LayerPlan, g: np.ndarray,
        send_weights: bool, x_host=None,
    ) -> scheduler.Pending:
        """The VJP's scatter; the card path as ``_scatter_conv_planned``
        has it, ``x_host`` the forward's host copy of ``x``.  Where the
        master computes on the card, each slave's slice of ``g`` crosses
        to the host on its own."""
        return self._scatter("bwd", x, g, plan, send_weights, x_host)

    def gather_bwd(self, p: scheduler.Pending) -> Tuple[np.ndarray, np.ndarray]:
        """The VJP's gather, as ``gather_conv`` has it: ``(dX, dW)``
        put together by the axis rule (``plans.axis``: partial dX summed
        or strips overlap-added or rows joined; dW shards joined or
        full-kernel parts summed)."""
        rule, parts = self._gather(p, "bwd")
        if rule.card:
            parts[1:] = [seam(p.device, "cluster.to_card", dx=dx, dw=dw)
                         for dx, dw in parts[1:]]
            return rule.assemble(p.plan, "bwd", parts, p.x)
        dx, dw = rule.assemble(p.plan, "bwd", parts, p.x)
        return seam(p.device, "cluster.to_card", dx=dx, dw=dw)

    def _scatter(
        self, op: str, x, g, plan: plans.LayerPlan, send_weights: bool, x_host,
    ) -> scheduler.Pending:
        """Send each slave its message (``plans.axis``): member k's part
        of the op, its weight slot as ``_wire_weights`` ships it and its
        operands on the host.  An axis whose master does not compute on
        the card converts x and g at the op's boundary first."""
        rule = plans.axis(plan)
        device = self._card(x)
        if device is not None and not rule.card:
            x = x_host if x_host is not None else seam(None, "cluster.to_host", x=x)
            if g is not None:
                g = seam(None, "cluster.to_host", g=g)
        socks = self._plan_sockets(plan)
        cut = rule.cut(plan, op, x, g)
        t0 = time.perf_counter()
        xs = self._slave_x(x, plan, x_host)
        for pos, sock in enumerate(socks, start=1):
            wire_op, (xk, wk, *rest) = rule.message(plan, op, pos, xs, g, cut)
            wk = self._wire_weights(sock, plan, pos, wk, send_weights)
            if g is not None:  # its slice of g (slot 2) crosses on its own
                rest[0] = seam(None, "cluster.to_host", g=rest[0])
            self._write_op(sock, (wire_op, (xk, wk, *rest)))
        now = time.perf_counter()
        self.timing.comm_s += now - t0
        spans.record("cluster.scatter", t0, now)
        self._seq_issued += 1
        return scheduler.Pending(
            op, self._seq_issued, x, g, cut, now, plan, socks,
            device=device, x_host=xs,
        )

    def _gather(self, p: scheduler.Pending, op: str):
        """(the op's axis rule, every member's result in device order):
        the master's own part, then each slave's, read from its link or
        recomputed."""
        self._check_order(p, op)
        t0 = time.perf_counter()
        parts = [self._master_compute(p)]
        t_wait = time.perf_counter()
        parts += [self._read_or_recover(sock, p, idx)
                  for idx, sock in enumerate(p.parts)]
        t1 = time.perf_counter()
        self._account_gather(p, t0, t_wait, t1)
        return plans.axis(p.plan), parts

    def _check_result(self, out):
        """Re-raise a slave's shipped exception at the gather that would
        otherwise consume its (missing) result."""
        if isinstance(out, protocol.SlaveError):
            raise RuntimeError(
                f"slave device {out.device} failed while computing its "
                f"shard:\n{out.tb}"
            )
        return out

    def _read_or_recover(self, sock, p: scheduler.Pending, idx: int):
        """Device ``idx+1``'s contribution to this gather: read it from
        the live link, or — the slave being gone — compute it HERE.
        The master re-issues the lost shard's work to itself from the
        plan the op rode, so every in-flight op drains on the survivors
        with identical numerics.  A ``SlaveError`` (the slave computed
        and FAILED) still raises: that is a broken backend, not a
        broken link."""
        if not sock.lost:
            try:
                return self._check_result(sock.read_on_master())
            except SlaveLost as e:
                self._on_slave_lost(sock, e)
        return self._recover_shard(p, idx + 1)

    def _recover_shard(self, p: scheduler.Pending, dev_pos: int):
        """Compute plan position ``dev_pos``'s part of the pending op on
        the master's own backend — the recovery path for a member that
        died between scatter and gather — as its message, built from the
        op's operands and cut as the master holds them (on the batch
        axis, the rows the op actually shipped, re-cut per slab), timed
        into ``LayerTiming.recompute_s`` (the span ``cluster.recover``)."""
        out, seconds = self._run_member(p, dev_pos, "cluster.recover")
        self.timing.recompute_s += seconds
        return out

    def _check_order(self, p: scheduler.Pending, op: str):
        # real exceptions, not asserts: an out-of-order gather would pair
        # one scatter's master shard with another's slave outputs and
        # return silently corrupted feature maps (and -O strips asserts)
        if p.op != op:
            raise RuntimeError(f"pending is a {p.op!r} op, gathered as {op!r}")
        if p.seq != self._seq_gathered + 1:
            raise RuntimeError(
                "gathers must follow scatter order (FIFO links): "
                f"expected seq {self._seq_gathered + 1}, got {p.seq}"
            )
        self._seq_gathered = p.seq

    def _master_compute(self, p: scheduler.Pending):
        """Member 0's part of ``p``, the master's own shard: the span
        ``cluster.master_shard`` (label ``operands``: ``card`` where its
        operands lie on the master's device, ``host`` where on numpy),
        timed into ``LayerTiming.master_conv_s``."""
        out, seconds = self._run_member(
            p, 0, "cluster.master_shard",
            operands="card" if self._card(p.x) is not None else "host",
        )
        self.timing.master_conv_s += seconds
        return out

    def _run_member(self, p: scheduler.Pending, pos: int, span: str, **labels):
        """Member ``pos``'s message of ``p`` run on the master's backend
        (``protocol.run_op``), stretched to the master's emulated
        slowdown and recorded as the span ``span``: (its result, the
        seconds it took)."""
        t0 = time.perf_counter()
        op, operands = plans.axis(p.plan).message(p.plan, p.op, pos, p.x, p.g, p.cut)
        out = protocol.run_op(self._master_backend, op, operands)
        el = time.perf_counter() - t0
        if self.slowdowns[0] > 1.0:
            # reprolint: allow=clock-injection -- slowdown emulation IS a real delay: it stretches measured compute to the emulated device's speed
            time.sleep(el * (self.slowdowns[0] - 1.0))
        t1 = time.perf_counter()
        spans.record(span, t0, t1, **labels)
        return out, t1 - t0

    def _account_gather(self, p: scheduler.Pending, t0, t_wait, t1):
        self.timing.conv_s += t1 - t0
        self.timing.gather_wait_s += t1 - t_wait
        spans.record("cluster.gather_wait", t_wait, t1)
        # in-flight window minus the time the master actually blocked:
        # the comm/compute overlap the pipeline buys
        self.timing.overlap_s += max(0.0, (t_wait - p.t_issued))

    def _master_comp(self, f, *args):
        """``f(*args)``: a master-only stage, timed into
        ``LayerTiming.comp_s`` (the master's non-conv duty)."""
        t0 = time.perf_counter()
        out = f(*args)
        t1 = time.perf_counter()
        self.timing.comp_s += t1 - t0
        spans.record("cluster.master_stage", t0, t1)
        return out

    # -- the schedules (core/cluster/scheduler.py) ------------------------
    def _n_micro(self, batch: int) -> int:
        if not self.pipeline:
            return 1
        return max(1, min(self.microbatches, batch))

    def microbatch_slices(self, batch: int) -> List[slice]:
        """The batch-axis slices the pipelined schedules will cut —
        drivers split labels/targets identically (see
        ``scheduler.microbatch_slices``)."""
        return scheduler.microbatch_slices(self, batch)

    def conv_forward(self, x, w, *, partition: Optional[str] = None):
        """Distributed convolution of one layer; microbatches are
        double-buffered when the cluster is pipelined.  See
        ``scheduler.conv_forward``."""
        return scheduler.conv_forward(self, x, w, partition=partition)

    def conv_backward(self, x, w, g, *, partition: Optional[str] = None):
        """Distributed VJP of one layer: returns ``(dx, dw)``.  See
        ``scheduler.conv_backward``."""
        return scheduler.conv_backward(self, x, w, g, partition=partition)

    def conv_forward_chain(self, x, layer_weights, between=None):
        """Forward pass of consecutive conv layers with master-only
        ``between`` stages pipelined against slave compute.  See
        ``scheduler.conv_forward_chain``."""
        return scheduler.conv_forward_chain(self, x, layer_weights, between)

    def conv_train_chain(self, x, layer_weights, between=None, head=None):
        """One fully-pipelined distributed training step (forward +
        backward) over consecutive conv layers; returns a
        ``TrainStepResult``.  See ``scheduler.conv_train_chain``."""
        return scheduler.conv_train_chain(self, x, layer_weights, between, head)

    def conv_train_step(self, x, layer_weights, between=None, head=None, *,
                        update=None):
        """``conv_train_chain`` plus the optimizer step on the conv
        kernels: returns ``(new_weights, TrainStepResult)``.  See
        ``scheduler.conv_train_step``."""
        return scheduler.conv_train_step(
            self, x, layer_weights, between, head, update=update
        )

    # ---------------------------------------------------------------------
    @property
    def comm_bytes(self) -> int:
        """Total bytes crossed master<->slave links since the last
        ``reset_stats`` (canonical codec accounting, both ways)."""
        return sum(s.total_bytes for s in self.sockets)

    def reset_stats(self):
        """Zero the timing breakdown, the comp-duty marks, and every
        link's byte counters (benchmarks call this between phases)."""
        self.timing = scheduler.LayerTiming()
        self._duty_mark = (0.0, 0.0)
        for s in self.sockets:
            s.reset_counters()

    def shutdown(self):
        """Tear the cluster down: every live slave is told to exit
        (``TRAIN_OVER``), joined/reaped, and every link closed.
        Idempotent; also runs at interpreter exit via ``atexit``."""
        if self._shut:
            return
        self._shut = True
        for s in self.sockets:
            try:
                s.write_to_slave(protocol.TRAIN_OVER)
            except RuntimeError:  # link already down (dead slave)
                pass
        for t in self.threads:
            if t is not None:
                t.join(timeout=10)
        deadline = self._clock() + 10
        for p in self.procs:
            if p is None:  # external join: its operator owns the process
                continue
            try:
                p.wait(timeout=max(0.1, deadline - self._clock()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        for s in self.sockets:
            s.close()
        if self._listener is not None:
            self._listener.close()


def make_distributed_conv(cluster: HeteroCluster):
    """A drop-in ``conv_fn(params, x)`` for models/cnn.py: a
    ``torch.autograd.Function`` whose forward runs ``cluster.
    conv_forward`` (plus the bias) and whose backward runs ``cluster.
    conv_backward`` (plus ``db = g.sum((0, 1, 2))``).  If the cluster is
    pipelined, every conv call is internally microbatched and
    double-buffered.

    The JAX package's version refuses a non-numpy master and
    interpret-mode pallas slaves: its host callbacks block the jax
    runtime thread, and re-entering jax there deadlocks.  Autograd calls
    this Function's forward and backward as plain Python on the calling
    thread, with nothing blocked, so any master backend is safe and
    neither refusal is kept."""
    import torch

    def like(a, t):
        return seam(t.device, a=a).to(t.dtype)

    class DistributedConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            ctx.save_for_backward(x, w)
            return like(cluster.conv_forward(*seam(None, x=x, w=w)), x) + b

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            dx, dw = cluster.conv_backward(*seam(None, x=x, w=w, g=g))
            return like(dx, x), like(dw, w), g.sum((0, 1, 2))

    def conv_fn(params, x):
        return DistributedConv.apply(x, params["kernel"], params["bias"])

    return conv_fn
