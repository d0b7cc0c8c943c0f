"""Pluggable wire transports for the master/slave cluster.

A ``Transport`` is the MASTER-side handle of one master<->slave link.
The contract the whole runtime (scatter/gather, scheduler, benches,
tests) is written against:

    write_to_slave(obj)   — enqueue a message to the slave; returns
                            immediately (the NIC DMAs asynchronously)
    read_on_master()      — block for the slave's next message (FIFO)
    bytes_to_slave /      — canonical wire-byte counters per direction
    bytes_to_master         (codec.wire_nbytes of the ENCODED message,
                            identical accounting on every transport)
    close()               — release link resources

The slave side only ever needs ``send``/``recv`` — a ``slave endpoint``
— so the same protocol loop runs in a thread (in-proc) or in a spawned
OS process (TCP).

Three implementations:

``InProcTransport`` — the seed behaviour: a queue pair standing in for
the paper's socket, with optional finite-``bandwidth_mbps`` emulation
(per-direction delivery threads sleep bytes/bandwidth before handing a
message over) and the wire codec.  Both endpoints live in this
process; ``slave_endpoint()`` returns the view a slave thread drives.

``TCPTransport`` — a real localhost/network socket: length-prefixed
pickle frames, codec applied before pickling, TCP_NODELAY, and an async
writer thread so ``write_to_slave`` returns immediately (matching the
in-proc semantics and making the deep pipelined schedules immune to
send/recv buffer deadlock).  ``frame_bytes_*`` additionally record the
ACTUAL framed sizes (pickle + header overhead) next to the canonical
counters, and ``measure_bandwidth_mbps`` times a real echo round-trip
through the slave — the measured link the comm-aware partitioner
consumes instead of the ``bandwidth_mbps`` knob.

``ShmTransport`` — the zero-copy wire for CO-LOCATED slave
subprocesses: bulk array bytes are written ONCE into a
``multiprocessing.shared_memory`` ring buffer and mapped on the far
side; only tiny control frames (the message skeleton, with arrays
replaced by ring segment descriptors) cross a localhost socket.  No
pickling of array payloads, no per-megabyte syscalls.  It subclasses
``TCPTransport``, so auth, heartbeats, liveness deadlines, counters
and the bandwidth probe all behave identically — the probe simply
measures the ring instead of the socket.

Every transport routes messages through a per-link ``codec.WireCodec``
(the compressor stack), and counts ``codec.wire_nbytes`` of the ENCODED
message — identical canonical accounting everywhere.

Liveness: ``SlaveLost`` is the transport's "this link's slave is gone"
signal — EOF/reset on the socket, a failed writer, or (with
``heartbeat_timeout_s`` set) no frame of ANY kind within the deadline.
Slave processes beat through ``TCPSlaveEndpoint.start_heartbeat``: a
daemon thread sends tiny ``(HEARTBEAT, seq)`` frames that the master's
read loop consumes silently (they count as liveness, never as protocol
traffic), so a wedged or SIGSTOPped slave is detected within the
deadline instead of hanging the scheduler forever.

Import-light on purpose (numpy + stdlib): TCP slave subprocesses import
this module before any heavy framework lands.
"""
from __future__ import annotations

import abc
import pickle
import queue
import select
import socket
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cluster import codec

TRANSPORT_KINDS = ("inproc", "tcp", "shm")

HEARTBEAT = "hb"  # liveness frame tag: (HEARTBEAT, seq), never an op


def is_heartbeat(obj) -> bool:
    """Whether a received frame is a liveness beat (``(HEARTBEAT,
    seq)``) rather than an op result."""
    # the first-element type check matters: op results are tuples too,
    # and ``ndarray == str`` compares elementwise
    return (
        isinstance(obj, tuple)
        and len(obj) == 2
        and isinstance(obj[0], str)
        and obj[0] == HEARTBEAT
    )


class SlaveLost(RuntimeError):
    """The link's slave is dead or unreachable: the socket hit EOF/reset,
    the writer thread failed, or no frame (op result OR heartbeat)
    arrived within the heartbeat deadline.  A RuntimeError subclass so
    pre-elastic callers that caught RuntimeError still do — but the
    cluster's recovery path catches THIS type specifically and
    re-partitions instead of aborting the step."""


class Transport(abc.ABC):
    """Master-side contract of one master<->slave link (see module doc)."""

    wire_dtype: Optional[np.dtype] = None
    bytes_to_slave: int = 0
    bytes_to_master: int = 0
    # set (by the transport or the cluster) once the slave behind this
    # link is known dead: scatters skip it, gathers recompute its shard
    # on the master instead of reading, writes/reads raise SlaveLost
    lost: bool = False

    @abc.abstractmethod
    def write_to_slave(self, obj) -> None:
        """Queue one message toward the slave; must return without
        blocking on delivery (comm overlaps compute).  Raises
        SlaveLost/RuntimeError when the link is known down."""
        ...

    @abc.abstractmethod
    def read_on_master(self):
        """Block for the slave's next op result (heartbeats are
        filtered out).  Raises SlaveLost on EOF, writer failure, or a
        missed heartbeat deadline."""
        ...

    @property
    def total_bytes(self) -> int:
        """Bytes crossed in both directions since the last reset
        (encoded wire size, not in-memory size)."""
        return self.bytes_to_slave + self.bytes_to_master

    def reset_counters(self) -> None:
        """Zero both directions' byte counters."""
        self.bytes_to_slave = 0
        self.bytes_to_master = 0

    def close(self) -> None:
        """Release link resources; default is a no-op."""

    def measure_bandwidth_mbps(self, **_kw) -> Optional[float]:
        """Measured link speed in Mbps, or None when the link has no
        meaningful finite speed to report (in-proc unlimited queues)."""
        return None


class SharedNIC:
    """One emulated network interface SHARED by every in-proc link of a
    node — the master-ingress bottleneck the two-tier hierarchy exists
    to relieve.

    Per-link ``bandwidth_mbps`` emulation models N independent wires: N
    slaves can each stream at the full link rate simultaneously, which
    is exactly the regime where a single master never saturates.  A real
    master has ONE NIC: all inbound gathers (and all outbound scatters)
    share its capacity, so six slaves returning full dW tensors serialize
    behind each other on the master's ingress.  ``SharedNIC`` models that
    with one transmit cursor per direction: each message reserves the
    next ``nbytes * 8 / bandwidth`` window after the cursor (under a
    brief lock), the cursor advances, and the link's delivery thread
    sleeps until its window's finish time.  Messages on DIFFERENT links
    therefore serialize per direction, exactly like frames sharing one
    physical port; the two directions are full-duplex and independent.

    Composes with per-link ``bandwidth_mbps`` (both delays apply — a
    slow last-hop behind a shared trunk); on its own it is the fair
    "one port on the master" model the ``hierarchy_vs_flat_gain`` bench
    uses to compare a flat 6-slave fan-in against 2 sub-master uplinks.
    """

    #: the two transmit directions, one independent cursor each
    DIRECTIONS = ("down", "up")  # down = master->slave, up = slave->master

    def __init__(self, bandwidth_mbps: float):
        if not bandwidth_mbps or bandwidth_mbps <= 0:
            raise ValueError(
                f"SharedNIC needs a positive bandwidth, got {bandwidth_mbps!r}"
            )
        self.bandwidth_mbps = float(bandwidth_mbps)
        self._lock = threading.Lock()
        self._free = {d: 0.0 for d in self.DIRECTIONS}

    def reserve(self, direction: str, nbytes: int) -> float:
        """Reserve the next transmit window on ``direction`` for a
        ``nbytes`` message and return its absolute finish time (on the
        ``time.perf_counter`` clock).  The caller sleeps until then
        OUTSIDE this call — the lock only guards the cursor arithmetic,
        never a wait."""
        transit = nbytes * 8.0 / (self.bandwidth_mbps * 1e6)
        now = time.perf_counter()
        with self._lock:
            start = max(now, self._free[direction])
            finish = start + transit
            self._free[direction] = finish
        return finish


class _InProcSlaveEndpoint:
    """The slave-thread view of an in-proc link: bare send/recv."""

    def __init__(self, link: "InProcTransport"):
        self._link = link

    def send(self, obj) -> None:
        self._link.write_to_master(obj)

    def recv(self):
        return self._link.read_on_slave()

    def close(self) -> None:  # the master side owns the queues
        ...


class InProcTransport(Transport):
    """Queue pair standing in for the paper's TCP socket; counts traffic.

    With ``bandwidth_mbps`` set, each direction gets a delivery thread
    that sleeps ``bytes * 8 / bandwidth`` before handing a message over —
    a full-duplex link of finite speed (the paper's ~5 Mbps Wi-Fi).
    Writers return immediately (the NIC DMAs asynchronously), so comm
    can genuinely overlap compute when the protocol allows it; messages
    on one direction serialize, exactly like a real link.

    Messages route through the link's ``WireCodec`` (``wire_codec``, or
    the single-``wire_dtype`` stack when only the legacy knob is given):
    float arrays are ENCODED on write and decoded back to float32 on
    read.  Byte counters and the bandwidth emulation see the encoded
    size, exactly like a real narrow wire.

    With ``nic`` (a :class:`SharedNIC`) set, the link ADDITIONALLY
    reserves a transmit window on the node's shared per-direction
    cursor for every message, so traffic on sibling links serializes
    behind this one exactly like frames sharing the master's single
    physical port."""

    def __init__(
        self,
        bandwidth_mbps: Optional[float] = None,
        wire_dtype: Optional[np.dtype] = None,
        wire_codec: Optional[codec.WireCodec] = None,
        nic: Optional[SharedNIC] = None,
    ):
        self.to_slave: "queue.Queue" = queue.Queue()
        self.to_master: "queue.Queue" = queue.Queue()
        self.bytes_to_slave = 0
        self.bytes_to_master = 0
        self._lock = threading.Lock()
        self.bandwidth_mbps = bandwidth_mbps
        self.nic = nic
        self._staged = bandwidth_mbps is not None or nic is not None
        self.wire_dtype = wire_dtype
        self._codec = (
            wire_codec if wire_codec is not None
            else codec.WireCodec.from_wire_dtype(wire_dtype)
        )
        if self._staged:
            assert bandwidth_mbps is None or bandwidth_mbps > 0
            self._stage_to_slave: "queue.Queue" = queue.Queue()
            self._stage_to_master: "queue.Queue" = queue.Queue()
            for stage, dest, direction in (
                (self._stage_to_slave, self.to_slave, "down"),
                (self._stage_to_master, self.to_master, "up"),
            ):
                threading.Thread(
                    target=self._deliver, args=(stage, dest, direction),
                    daemon=True,
                ).start()

    _LINK_DOWN = object()  # sentinel: stops a delivery thread

    def _deliver(self, stage: "queue.Queue", dest: "queue.Queue",
                 direction: str):
        while True:
            item = stage.get()
            if item is InProcTransport._LINK_DOWN:
                return
            obj, nbytes = item
            if self.bandwidth_mbps is not None:
                # reprolint: allow=clock-injection -- bandwidth emulation IS a real delay: the sleep models wire transit time and must consume wall clock
                time.sleep(nbytes * 8.0 / (self.bandwidth_mbps * 1e6))
            if self.nic is not None:
                wait = self.nic.reserve(direction, nbytes) - time.perf_counter()
                if wait > 0:
                    # reprolint: allow=clock-injection -- shared-NIC emulation: sleeping until the reserved transmit window ends IS the modeled serialization delay
                    time.sleep(wait)
            dest.put(obj)

    def close(self):
        """Stop the delivery threads (queued messages drain first)."""
        if self._staged:
            self._stage_to_slave.put(InProcTransport._LINK_DOWN)
            self._stage_to_master.put(InProcTransport._LINK_DOWN)

    # -- both link directions ---------------------------------------------
    def _nbytes(self, obj) -> int:
        return codec.wire_nbytes(obj)

    def write_to_slave(self, obj):
        """Encode + count, then queue toward the slave — through the
        bandwidth-emulating stage when the link is finite."""
        obj = self._codec.encode_down(obj)
        n = self._nbytes(obj)
        with self._lock:
            self.bytes_to_slave += n
        if self._staged:
            self._stage_to_slave.put((obj, n))
        else:
            self.to_slave.put(obj)

    def write_to_master(self, obj):
        """Slave-side mirror of ``write_to_slave``."""
        obj = self._codec.encode_up(obj)
        n = self._nbytes(obj)
        with self._lock:
            self.bytes_to_master += n
        if self._staged:
            self._stage_to_master.put((obj, n))
        else:
            self.to_master.put(obj)

    def read_on_slave(self):
        """Block for the master's next message (slave side)."""
        return self._codec.decode(self.to_slave.get())

    def read_on_master(self):
        """Block for the slave's next result, decoding the codec stack."""
        return self._codec.decode(self.to_master.get())

    def slave_endpoint(self) -> _InProcSlaveEndpoint:
        """The send/recv pair the slave thread drives."""
        return _InProcSlaveEndpoint(self)

    def measure_bandwidth_mbps(self, **_kw) -> Optional[float]:
        """The emulated knob IS the link speed; None = infinitely fast."""
        return self.bandwidth_mbps


# ---------------------------------------------------------------------------
# TCP: length-prefixed pickle frames over a real socket.
# ---------------------------------------------------------------------------

_HDR = struct.Struct(">Q")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("transport connection closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return _recv_exact(sock, n)


def _dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


class TCPListener:
    """The master's accept socket; slaves connect to (host, port).

    ``host`` picks the bind interface: the localhost default keeps the
    pre-elastic behaviour (only processes on this machine can join);
    ``"0.0.0.0"`` accepts slaves from genuinely remote hosts — pair it
    with the cluster auth token, the wire is pickle.  ``port=0`` (the
    default) lets the kernel pick a free port; a fixed port is what a
    remote-slave quickstart advertises to its operators."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]

    def accept(self, timeout_s: float = 60.0) -> socket.socket:
        """Block for one inbound slave connection.

        Args:
            timeout_s: seconds before ``socket.timeout`` is raised.

        Returns:
            The accepted (pre-handshake) connection socket.
        """
        self._sock.settimeout(timeout_s)
        conn, _addr = self._sock.accept()
        return conn

    def close(self) -> None:
        """Close the listening socket (accepted links live on)."""
        try:
            self._sock.close()
        except OSError:  # pragma: no cover - already closed
            pass


class TCPTransport(Transport):
    """Master-side endpoint of a real master<->slave TCP link.

    Frames are 8-byte big-endian length + pickle payload; the codec
    encodes BEFORE pickling so the real wire carries 2-byte floats.
    Writes are queued to a writer thread — ``write_to_slave`` returns
    immediately, preserving the async-NIC semantics the pipelined
    schedules assume and decoupling deep in-flight windows from the
    kernel's socket buffer sizes.  ``bytes_to_*`` count the canonical
    codec bytes (comparable with InProcTransport); ``frame_bytes_to_*``
    count what actually crossed the socket, framing included.

    ``heartbeat_timeout_s`` arms the liveness deadline: the read loop
    polls the socket (``select``, never consuming a partial frame) and
    raises ``SlaveLost`` once NO frame — result or heartbeat — has
    arrived within the deadline.  Heartbeat frames refresh the deadline
    and are consumed silently (no byte accounting: they are liveness,
    not protocol traffic).  EOF/reset raises ``SlaveLost`` immediately
    with or without a deadline — a SIGKILLed slave's kernel closes its
    socket, so crashes are detected at wire speed and only a wedged or
    SIGSTOPped slave needs the heartbeat clock."""

    _WRITER_DOWN = object()
    _POLL_S = 0.25  # deadline-check granularity while waiting for frames

    def __init__(
        self,
        conn: socket.socket,
        wire_dtype: Optional[np.dtype] = None,
        heartbeat_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        wire_codec: Optional[codec.WireCodec] = None,
    ):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conn = conn
        self.wire_dtype = wire_dtype
        self._codec = (
            wire_codec if wire_codec is not None
            else codec.WireCodec.from_wire_dtype(wire_dtype)
        )
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._clock = clock
        self.last_alive = self._clock()
        self.lost = False
        self.bytes_to_slave = 0
        self.bytes_to_master = 0
        self.frame_bytes_to_slave = 0
        self.frame_bytes_to_master = 0
        self._closed = False
        self._werr: Optional[BaseException] = None
        self._wq: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._writer.start()

    def _write_loop(self):
        while True:
            item = self._wq.get()
            if item is TCPTransport._WRITER_DOWN:
                return
            try:
                if not isinstance(item, (bytes, bytearray)):
                    item = self._serialize(item)  # shm: pack in-thread
                _send_frame(self._conn, item)
            except BaseException as e:  # surface on the next master call
                self._werr = e
                return

    def _check_writer(self):
        if self._werr is not None:
            self.lost = True
            raise SlaveLost(
                f"TCP link writer failed (slave died or connection dropped): "
                f"{self._werr!r}"
            )

    def _check_lost(self):
        if self.lost:
            raise SlaveLost("TCP link already marked lost")

    def write_to_slave(self, obj):
        """Encode + frame ``obj`` and queue it to the writer thread;
        returns immediately.  Raises SlaveLost when the link is marked
        lost or the writer already failed."""
        self._check_lost()
        self._check_writer()
        obj = self._codec.encode_down(obj)
        self.bytes_to_slave += codec.wire_nbytes(obj)
        self._enqueue(obj)

    def _enqueue(self, obj) -> None:
        """Serialize the encoded message and hand it to the writer
        thread.  (``ShmTransport`` overrides: packing into the ring must
        happen IN the writer thread, so ring backpressure blocks the
        writer, never the scheduler.)"""
        payload = _dumps(obj)
        self.frame_bytes_to_slave += len(payload) + _HDR.size
        self._wq.put(payload)

    def _serialize(self, obj) -> bytes:
        """Writer-thread serialization hook for non-bytes queue items;
        only the shm subclass enqueues those."""
        raise RuntimeError(f"unserialized item on TCP writer queue: {obj!r}")

    def _loads(self, payload: bytes):
        """Deserialize one inbound frame payload (shm overrides to read
        array segments out of its ring)."""
        return pickle.loads(payload)

    def read_on_master(self):
        """Next non-heartbeat frame from the slave, decoded.  With a
        heartbeat deadline armed, waits in ``select`` polls so buffered
        heartbeats refresh ``last_alive`` before the deadline is judged
        (a master that was busy computing must drain the backlog, not
        declare a live slave dead on a stale clock)."""
        while True:
            self._check_lost()
            self._check_writer()
            if self.heartbeat_timeout_s is not None:
                deadline = self.last_alive + self.heartbeat_timeout_s
                wait = min(max(0.0, deadline - self._clock()), self._POLL_S)
                readable, _, _ = select.select([self._conn], [], [], wait)
                if not readable:
                    if self._clock() >= deadline:
                        self.lost = True
                        raise SlaveLost(
                            f"no frame or heartbeat from slave for "
                            f"{self.heartbeat_timeout_s:.2f}s (deadline "
                            f"exceeded): slave wedged or unreachable"
                        )
                    continue
            try:
                # with a deadline armed, the frame body is read under a
                # per-chunk socket timeout: select only promises the
                # FIRST byte, and a peer that stalls mid-frame (SIGSTOP
                # between chunks of a multi-MB result) must still trip
                # the deadline, not hang a timeout-less recv forever
                if self.heartbeat_timeout_s is not None:
                    self._conn.settimeout(self.heartbeat_timeout_s)
                payload = _recv_frame(self._conn)
            except socket.timeout as e:
                self.lost = True
                raise SlaveLost(
                    f"slave stalled mid-frame for "
                    f"{self.heartbeat_timeout_s:.2f}s (deadline "
                    f"exceeded): slave wedged or unreachable"
                ) from e
            except (EOFError, OSError) as e:
                self.lost = True
                raise SlaveLost(
                    f"TCP link to slave closed mid-protocol: {e!r}"
                ) from e
            finally:
                if self.heartbeat_timeout_s is not None:
                    try:
                        self._conn.settimeout(None)
                    except OSError:  # pragma: no cover - socket already dead
                        pass
            self.last_alive = self._clock()
            obj = self._loads(payload)
            if is_heartbeat(obj):
                continue  # liveness only: no byte accounting, not a result
            self.bytes_to_master += codec.wire_nbytes(obj)
            self.frame_bytes_to_master += len(payload) + _HDR.size
            return self._codec.decode(obj)

    def reset_counters(self) -> None:
        """Zero the canonical AND the on-the-wire frame byte counters."""
        super().reset_counters()
        self.frame_bytes_to_slave = 0
        self.frame_bytes_to_master = 0

    def measure_bandwidth_mbps(
        self, payload_bytes: int = 1 << 20, repeats: int = 3, **_kw
    ) -> Optional[float]:
        """Round-trip a ``payload_bytes`` echo through the slave's
        protocol loop and return the best observed Mbps (payload bytes
        moved in BOTH directions over the round-trip wall-clock) — the
        measured link the comm-aware Eq. 1 consumes.  Uses a uint8
        payload so the codec (which narrows only float arrays) does not
        skew the measurement."""
        arr = np.zeros(payload_bytes, np.uint8)
        # probes are not protocol traffic: restore EVERY counter family
        # (canonical and frame) once the measurement is done
        saved = (
            self.bytes_to_slave, self.bytes_to_master,
            self.frame_bytes_to_slave, self.frame_bytes_to_master,
        )
        best = 0.0
        try:
            for _ in range(repeats + 1):  # first round warms buffers; dropped
                t0 = time.perf_counter()
                self.write_to_slave(("ping", arr))
                echo = self.read_on_master()
                dt = time.perf_counter() - t0
                if not isinstance(echo, np.ndarray) or echo.nbytes != arr.nbytes:
                    # RuntimeError, not assert: -O must not turn a garbled
                    # echo into a nonsense Eq. 1 planning bandwidth
                    raise RuntimeError(
                        f"bandwidth probe echo mismatch: sent {arr.nbytes}B, "
                        f"got {type(echo).__name__}"
                    )
                best = max(best, 2.0 * arr.nbytes * 8.0 / (dt * 1e6))
        finally:
            (self.bytes_to_slave, self.bytes_to_master,
             self.frame_bytes_to_slave, self.frame_bytes_to_master) = saved
        return best

    def close(self) -> None:
        """Stop the writer thread and shut the socket down both ways;
        idempotent."""
        if self._closed:
            return
        self._closed = True
        self._wq.put(TCPTransport._WRITER_DOWN)
        self._writer.join(timeout=5)
        try:
            self._conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._conn.close()
        except OSError:  # pragma: no cover - already closed
            pass


class TCPSlaveEndpoint:
    """Slave-side endpoint: connects to the master's listener and speaks
    the same framed-pickle wire (codec included).  Drives ``slave_loop``
    inside a spawned subprocess — or a thread, for conformance tests.

    ``connect_timeout_s`` is a RETRY window, not a single attempt: a
    hand-launched remote slave may race the master's bind (two
    terminals, two hosts), so refused connections are retried with a
    short sleep until the deadline.  ``start_heartbeat`` arms the
    liveness beacon: a daemon thread sends ``(HEARTBEAT, seq)`` frames
    every interval — concurrently with the op loop's results, which is
    why every ``send`` serializes under a lock (interleaved partial
    frames would corrupt the wire)."""

    _RETRY_S = 0.25

    def __init__(
        self,
        host: str,
        port: int,
        wire_dtype: Optional[np.dtype] = None,
        connect_timeout_s: float = 30.0,
        auth_token: Optional[bytes] = None,
        wire_codec: Optional[codec.WireCodec] = None,
    ):
        self._codec = (
            wire_codec if wire_codec is not None
            else codec.WireCodec.from_wire_dtype(wire_dtype)
        )
        # reprolint: allow=clock-injection -- slave-process side: a spawned subprocess racing a real bind has no master to inject a clock, and the retry window must measure real wall time
        deadline = time.monotonic() + connect_timeout_s
        while True:
            try:
                self._conn = socket.create_connection(
                    (host, port),
                    # reprolint: allow=clock-injection -- same real connect-retry window as above
                    timeout=max(self._RETRY_S, deadline - time.monotonic()),
                )
                break
            except OSError:
                # master not listening yet (or transient network blip):
                # retry until the window closes
                # reprolint: allow=clock-injection -- same real connect-retry window as above
                if time.monotonic() + self._RETRY_S >= deadline:
                    raise
                # reprolint: allow=clock-injection -- real backoff between real connect attempts
                time.sleep(self._RETRY_S)
        self._conn.settimeout(None)  # ops block indefinitely, like the queues
        self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.wire_dtype = wire_dtype
        self._send_lock = threading.Lock()
        if auth_token is not None:
            # RAW token bytes before any frame: the master refuses to
            # unpickle anything from a connection that cannot present
            # the per-cluster secret (see HeteroCluster handshake)
            self._conn.sendall(auth_token)

    def send(self, obj) -> None:
        """Encode + frame ``obj`` to the master, serialized under the
        send lock (results and heartbeats share the socket)."""
        obj = self._codec.encode_up(obj)
        payload = _dumps(obj)
        with self._send_lock:
            # reprolint: allow=blocking-under-lock -- the lock EXISTS to serialize the blocking send: heartbeats and results share one socket, and an interleaved partial frame corrupts the wire
            _send_frame(self._conn, payload)

    def recv(self):
        """Block for the master's next frame, decoded."""
        return self._codec.decode(pickle.loads(_recv_frame(self._conn)))

    def start_heartbeat(self, interval_s: float) -> threading.Thread:
        """Beat ``(HEARTBEAT, seq)`` every ``interval_s`` from a daemon
        thread, proving liveness even while the op loop is deep in a
        long convolution.  The thread dies silently with the socket."""

        def _beat():
            seq = 0
            while True:
                # reprolint: allow=clock-injection -- the heartbeat beacon proves REAL wall-clock liveness from the slave process; a fake clock here would defeat the deadline it feeds
                time.sleep(interval_s)
                try:
                    self.send((HEARTBEAT, seq))
                except OSError:
                    return  # link gone: the op loop is exiting too
                seq += 1

        t = threading.Thread(target=_beat, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        """Close the slave-side socket."""
        try:
            self._conn.close()
        except OSError:  # pragma: no cover - already closed
            pass


# ---------------------------------------------------------------------------
# shm: zero-copy shared-memory rings for co-located slaves; control
# frames (skeletons + segment descriptors) on a small localhost socket.
# ---------------------------------------------------------------------------

_PLAIN = b"P"     # control-frame prefix: whole message pickled inline
_SKELETON = b"S"  # control-frame prefix: arrays parked in the ring


def _shm_untrack(shm: shared_memory.SharedMemory) -> None:
    """Detach an ATTACHED segment from this process's resource tracker.

    Python < 3.13 has no ``track=False``: an attacher re-registers the
    segment, and its tracker then unlinks it behind the creator's back
    (plus a spurious "leaked shared_memory" warning at exit).  Only the
    creating ``ShmTransport`` owns unlink."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(
            getattr(shm, "_name", "/" + shm.name), "shared_memory"
        )
    except (ImportError, OSError, ValueError):  # pragma: no cover
        pass  # best-effort: worst case is one warning at interpreter exit


class _ShmRing:
    """Single-producer/single-consumer byte ring over ONE SharedMemory
    segment.

    Layout: a 16-byte header — ``released`` (u64, absolute bytes the
    consumer has finished copying out, CONSUMER-written) and
    ``capacity`` (u64, creator-written, so both sides agree even when
    the kernel page-rounds the mapping) — followed by the circular data
    area.  The producer tracks its absolute write offset locally and
    blocks (tiny sleep poll, only under backpressure) while
    ``head - released`` leaves no room.  The 8-byte aligned u64 store
    of ``released`` is a single memcpy under CPython — de-facto atomic
    on every platform this runs on; the producer additionally clamps it
    to ``head``, so a torn read can at worst delay progress, and only
    while crossing a 4 GiB counter boundary."""

    _HDR_BYTES = 16
    _POLL_S = 100e-6

    def __init__(
        self,
        name: Optional[str] = None,
        data_bytes: Optional[int] = None,
        create: bool = False,
    ):
        if create:
            if not data_bytes or data_bytes <= 0:
                raise ValueError("creating a ring needs data_bytes > 0")
            self._shm = shared_memory.SharedMemory(
                create=True, size=self._HDR_BYTES + int(data_bytes)
            )
            struct.pack_into("<Q", self._shm.buf, 8, int(data_bytes))
            self.capacity = int(data_bytes)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            _shm_untrack(self._shm)
            self.capacity = struct.unpack_from("<Q", self._shm.buf, 8)[0]
        self._head = 0  # producer-local absolute write offset
        self._aborted = False

    @property
    def name(self) -> str:
        """OS name of the segment — what the setup frame advertises."""
        return self._shm.name

    def abort(self) -> None:
        """Unblock a producer parked on ring backpressure (link death /
        close): its wait loop raises instead of spinning forever."""
        self._aborted = True

    def release(self, upto: int) -> None:
        """Consumer: mark every byte below absolute offset ``upto`` as
        copied out and reusable."""
        struct.pack_into("<Q", self._shm.buf, 0, upto)

    def _released(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 0)[0]

    def write_array(self, a: np.ndarray) -> int:
        """Producer: park one array's bytes in the ring (wrapping), and
        return its absolute offset.  Blocks while the consumer lags by
        more than ``capacity - a.nbytes``."""
        a = np.ascontiguousarray(a)
        n = a.nbytes
        while self.capacity - (self._head - min(self._released(), self._head)) < n:
            if self._aborted:
                raise OSError("shm ring aborted (link closed) mid-write")
            # reprolint: allow=clock-injection -- ring backpressure IS real flow control: the producer must yield real wall time until the consumer frees space
            time.sleep(self._POLL_S)
        pos = self._head % self.capacity
        flat = a.reshape(-1).view(np.uint8)
        first = min(n, self.capacity - pos)
        h = self._HDR_BYTES
        self._shm.buf[h + pos:h + pos + first] = flat[:first]
        if n > first:
            self._shm.buf[h:h + n - first] = flat[first:]
        off = self._head
        self._head += n
        return off

    def read_array(self, off: int, nbytes: int, dtype, shape) -> np.ndarray:
        """Consumer: copy one parked array back out of the ring.  The
        ONE copy on the whole path — the producer's write is the only
        other touch of the bytes."""
        out = np.empty(nbytes, np.uint8)
        pos = off % self.capacity
        first = min(nbytes, self.capacity - pos)
        h = self._HDR_BYTES
        out[:first] = np.frombuffer(self._shm.buf, np.uint8, first, h + pos)
        if nbytes > first:
            out[first:] = np.frombuffer(
                self._shm.buf, np.uint8, nbytes - first, h
            )
        return out.view(dtype).reshape(shape)

    def close(self) -> None:
        """Detach this process's mapping (idempotent)."""
        self._aborted = True
        try:
            self._shm.close()
        except (OSError, BufferError):  # pragma: no cover - best effort
            pass

    def unlink(self) -> None:
        """Remove the OS segment — creator side only, after close()."""
        try:
            self._shm.unlink()
        except (OSError, FileNotFoundError):  # pragma: no cover
            pass


class _ShmSeg:
    """Control-frame descriptor of one array parked in the ring: where
    its bytes sit and how to view them.  Pickles tiny."""

    __slots__ = ("off", "nbytes", "dtype", "shape")

    def __init__(self, off: int, nbytes: int, dtype, shape):
        self.off = off
        self.nbytes = nbytes
        self.dtype = dtype
        self.shape = shape

    def __getstate__(self):
        return (self.off, self.nbytes, self.dtype, self.shape)

    def __setstate__(self, state):
        self.off, self.nbytes, self.dtype, self.shape = state


def _shm_pack(obj, ring: _ShmRing) -> bytes:
    """Build one control-frame payload: every array in ``obj`` is parked
    in the ring and replaced by a ``_ShmSeg``; the skeleton pickles
    small.  Degenerate or ring-overflowing arrays stay inline (the
    canonical byte accounting happened before any of this)."""

    def park(a: np.ndarray):
        if a.nbytes == 0 or a.nbytes > ring.capacity:
            return a
        off = ring.write_array(a)
        return _ShmSeg(off, a.nbytes, a.dtype, a.shape)

    return _SKELETON + _dumps(codec.map_arrays(obj, park))


def _shm_unpack(payload: bytes, ring: Optional[_ShmRing]):
    """Inverse of ``_shm_pack``: rebuild the message, copying each
    segment's bytes out of the ring, then release them for reuse."""
    kind, obj = payload[:1], pickle.loads(payload[1:])
    if kind != _SKELETON:
        return obj
    end = 0

    def fetch(seg: _ShmSeg) -> np.ndarray:
        nonlocal end
        arr = ring.read_array(seg.off, seg.nbytes, seg.dtype, seg.shape)
        end = max(end, seg.off + seg.nbytes)
        return arr

    out = codec.map_arrays(obj, fetch, leaf=_ShmSeg)
    if end:
        ring.release(end)
    return out


class ShmListener(TCPListener):
    """Listener for the shm transport's CONTROL channel.  Identical to
    ``TCPListener`` — what it accepts only ever carries the handshake,
    heartbeats and tiny skeleton frames; bulk arrays ride the
    shared-memory rings the accepted ``ShmTransport`` creates."""


class ShmTransport(TCPTransport):
    """Master-side endpoint of a zero-copy shared-memory link.

    Construction creates TWO rings (one per direction) and advertises
    their names to the slave in a ``("shm-setup", tx, rx)`` control
    frame — guaranteed first on the wire, the writer queue is empty at
    that point.  After setup, every frame is either ``_PLAIN`` (whole
    message inline: pre-setup handshake) or ``_SKELETON`` (arrays
    parked in the ring, descriptors on the socket): array bytes are
    written once by the producer and copied out once by the consumer —
    no pickling of bulk data, no per-megabyte socket syscalls.

    Everything else — auth-before-unpickle, the async writer, heartbeat
    deadlines, ``SlaveLost``, canonical + frame byte counters, and
    ``measure_bandwidth_mbps`` (which now times the RING, feeding Eq. 1
    the speed the plans will actually see) — is inherited from
    ``TCPTransport`` unchanged.  Ring packing happens in the writer
    thread, so ring backpressure blocks the writer, never the
    scheduler.  The master owns both segments: ``close()`` detaches AND
    unlinks them (slave endpoints only detach)."""

    DEFAULT_RING_BYTES = 64 << 20  # per direction; overflow falls inline

    def __init__(
        self,
        conn: socket.socket,
        wire_dtype: Optional[np.dtype] = None,
        heartbeat_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        wire_codec: Optional[codec.WireCodec] = None,
        ring_bytes: int = DEFAULT_RING_BYTES,
    ):
        self._tx = _ShmRing(data_bytes=ring_bytes, create=True)  # to slave
        self._rx = _ShmRing(data_bytes=ring_bytes, create=True)  # to master
        try:
            super().__init__(
                conn, wire_dtype, heartbeat_timeout_s, clock,
                wire_codec=wire_codec,
            )
        except BaseException:
            for ring in (self._tx, self._rx):
                ring.close()
                ring.unlink()
            raise
        self._wq.put(
            _PLAIN + _dumps(("shm-setup", self._tx.name, self._rx.name))
        )

    def _enqueue(self, obj) -> None:
        """Defer serialization to the writer thread (see class doc)."""
        self._wq.put(obj)

    def _serialize(self, obj) -> bytes:
        """Writer thread: park arrays in the tx ring, frame the skeleton."""
        payload = _shm_pack(obj, self._tx)
        self.frame_bytes_to_slave += len(payload) + _HDR.size
        return payload

    def _loads(self, payload: bytes):
        """Rebuild one inbound frame from the rx ring."""
        return _shm_unpack(payload, self._rx)

    def close(self) -> None:
        """Stop the writer (aborting any ring wait), close the control
        socket, then detach and unlink both rings; idempotent."""
        if self._closed:
            return
        self._tx.abort()  # a writer parked on backpressure must exit
        self._rx.abort()
        super().close()
        for ring in (self._tx, self._rx):
            ring.close()
            ring.unlink()


class ShmSlaveEndpoint(TCPSlaveEndpoint):
    """Slave-side endpoint of the shm link: connects to the control
    socket like a TCP slave (auth token and all), then attaches the two
    rings named by the master's ``shm-setup`` frame — transparently,
    inside ``recv``, so ``slave_loop`` needs no changes.  Sends pack
    under the send lock (results and heartbeats share one ring: single
    producer).  Detaches on close; the master owns unlink."""

    def __init__(
        self,
        host: str,
        port: int,
        wire_dtype: Optional[np.dtype] = None,
        connect_timeout_s: float = 30.0,
        auth_token: Optional[bytes] = None,
        wire_codec: Optional[codec.WireCodec] = None,
    ):
        super().__init__(
            host, port, wire_dtype, connect_timeout_s, auth_token,
            wire_codec=wire_codec,
        )
        self._tx_ring: Optional[_ShmRing] = None  # slave -> master
        self._rx_ring: Optional[_ShmRing] = None  # master -> slave

    def send(self, obj) -> None:
        """Encode, park arrays in the tx ring, frame the skeleton —
        all under the send lock (the ring is single-producer and the
        socket must carry whole frames)."""
        obj = self._codec.encode_up(obj)
        with self._send_lock:
            if self._tx_ring is not None:
                # reprolint: allow=blocking-under-lock -- single-producer ring + shared socket: both the ring write and the frame send MUST serialize under this lock or frames interleave
                payload = _shm_pack(obj, self._tx_ring)
            else:
                payload = _PLAIN + _dumps(obj)  # pre-setup (hello)
            # reprolint: allow=blocking-under-lock -- same single-producer serialization as above
            _send_frame(self._conn, payload)

    def recv(self):
        """Block for the master's next frame, consuming ``shm-setup``
        internally (ring attach) and decoding everything else."""
        while True:
            payload = _recv_frame(self._conn)
            obj = _shm_unpack(payload, self._rx_ring)
            if (
                isinstance(obj, tuple) and len(obj) == 3
                and isinstance(obj[0], str) and obj[0] == "shm-setup"
            ):
                self._rx_ring = _ShmRing(name=obj[1])
                self._tx_ring = _ShmRing(name=obj[2])
                continue
            return self._codec.decode(obj)

    def close(self) -> None:
        """Detach both ring mappings and close the control socket."""
        for ring in (self._tx_ring, self._rx_ring):
            if ring is not None:
                ring.close()
        super().close()
