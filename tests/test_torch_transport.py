"""Twin of tests/test_transport.py over ``repro_torch``: the in-proc
queue emulation, the real TCP wire and the shared-memory rings of the
port's ``core/cluster/transport.py`` are interchangeable behind one
contract, and deliver what the JAX package's links deliver.

Every case of the reference runs here with its parametrisation:
payload fidelity and FIFO order, the canonical byte accounting (the
reference's golden numbers, and equal to the JAX package's counters on
the same payload), slave-error propagation, measured link bandwidth,
the subprocess train chain on every partition axis against the
single-device VJP and against the JAX package's cluster (rtol 1e-4,
atol 1e-3, the reference's), orderly shutdown, and shm segment hygiene
with the inline fallback for arrays larger than the ring.  Port
clusters name their backends (``torch:cpu`` master, ``numpy`` slaves;
a ``torch:cpu`` slave process in the kernel-axis train chain), since the
port's default is the card.
"""
import os
import threading

import numpy as np
import pytest

from _torch_cluster_parity import (
    check,
    clusters,
    data,
    port_backends,
    ref_conv,
    single_device_grads,
    train_step,
)
from repro.core.cluster import codec as jax_codec
from repro.core.cluster import transport as jax_transport
from repro_torch.core.cluster import codec, transport
from repro_torch.core.master_slave import HeteroCluster

TRANSPORTS = ("inproc", "tcp", "shm")
PACKAGES = {"port": (transport, codec), "jax": (jax_transport, jax_codec)}


def _make_link(kind: str, wire_dtype=None, wire_codec=None, pkg="port", **chan_kw):
    """(master_channel, slave_endpoint, close) of one package's
    transport; the TCP/shm pairs cross a REAL localhost socket.  Each
    side gets its own codec instance, like the cluster builds per link."""
    tr, cd = PACKAGES[pkg]
    dtype = cd.resolve_wire_dtype(wire_dtype)

    def _codec():
        return cd.WireCodec.from_spec(wire_codec, wire_dtype)

    if kind == "inproc":
        link = tr.InProcTransport(None, dtype, wire_codec=_codec())
        return link, link.slave_endpoint(), link.close
    chan_cls, ep_cls = (
        (tr.ShmTransport, tr.ShmSlaveEndpoint) if kind == "shm"
        else (tr.TCPTransport, tr.TCPSlaveEndpoint)
    )
    listener = tr.TCPListener()
    slave_box = {}

    def _connect():
        slave_box["ep"] = ep_cls(
            listener.host, listener.port, dtype, wire_codec=_codec()
        )

    t = threading.Thread(target=_connect)
    t.start()
    chan = chan_cls(
        listener.accept(timeout_s=10), dtype, wire_codec=_codec(), **chan_kw
    )
    t.join(timeout=10)
    assert not t.is_alive()
    slave = slave_box["ep"]

    def _close():
        chan.close()
        slave.close()
        listener.close()

    return chan, slave, _close


def _payload(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(2, 4, 4, 3)).astype(np.float32),
        "nested": (np.arange(5, dtype=np.float64), [np.ones(3, np.float32)]),
        "ints": np.arange(4, dtype=np.int32),
        "flag": "keep-me",
    }


def _through(kind, msg, pkg, **kw):
    """What one package's link delivers for ``msg``, and the canonical
    bytes it counted."""
    chan, slave, close = _make_link(kind, pkg=pkg, **kw)
    try:
        chan.write_to_slave(msg)
        return slave.recv(), chan.bytes_to_slave
    finally:
        close()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_roundtrip_fifo_both_directions(kind):
    """Messages cross intact (nested containers, dtypes, strings) and in
    FIFO order, in both directions — and each equals what the JAX
    package's link of the same kind delivers."""
    chan, slave, close = _make_link(kind)
    try:
        msgs = [_payload(s) for s in range(3)]
        for m in msgs:
            chan.write_to_slave(m)
        for m in msgs:
            got = slave.recv()
            assert got["flag"] == "keep-me"
            np.testing.assert_array_equal(got["x"], m["x"])
            np.testing.assert_array_equal(got["nested"][0], m["nested"][0])
            assert got["ints"].dtype == np.int32
            theirs, _ = _through(kind, m, "jax")
            for key in ("x", "ints"):
                assert got[key].dtype == theirs[key].dtype
                np.testing.assert_array_equal(got[key], theirs[key])
            np.testing.assert_array_equal(got["nested"][0], theirs["nested"][0])
            assert got["nested"][0].dtype == theirs["nested"][0].dtype
            slave.send(("echo", got["ints"]))
        for m in msgs:
            tag, ints = chan.read_on_master()
            assert tag == "echo"
            np.testing.assert_array_equal(ints, m["ints"])
    finally:
        close()


# the reference's golden canonical bytes of _payload() under each wire
# setting: 96 float elements (x), 5 float64 (normalized to the codec
# dtype — float32 even on the uncompressed wire), 3 float32 (ones), 4
# int32 (never encoded), one string flag and FOUR dict keys at the
# 8-byte scalar rate.
_GOLDEN_BYTES = {
    (None, None): 96 * 4 + 5 * 4 + 3 * 4 + 16 + 8 + 4 * 8,      # 472
    ("fp16", None): 96 * 2 + 5 * 2 + 3 * 2 + 16 + 8 + 4 * 8,    # 264
    ("bf16", None): 96 * 2 + 5 * 2 + 3 * 2 + 16 + 8 + 4 * 8,    # 264
    # int8: each float tensor ships q.nbytes + one 8-byte scale
    (None, "int8"): (96 + 8) + (5 + 8) + (3 + 8) + 16 + 8 + 4 * 8,  # 184
}


@pytest.mark.parametrize("wire_dtype,wire_codec", sorted(
    _GOLDEN_BYTES, key=str
))
def test_nbytes_accounting_identical_across_transports(wire_dtype, wire_codec):
    """The canonical byte counters report the SAME golden number on the
    queue emulation, the real TCP wire and the shm rings, for every
    codec stage, in the port and in the JAX package."""
    counted = {}
    for pkg in PACKAGES:
        for kind in TRANSPORTS:
            _, counted[pkg, kind] = _through(
                kind, _payload(), pkg, wire_dtype=wire_dtype, wire_codec=wire_codec
            )
    want = _GOLDEN_BYTES[(wire_dtype, wire_codec)]
    assert counted == {key: want for key in counted}


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_float64_normalized_to_float32_on_uncompressed_wire(kind):
    """The fp32 (no-codec) wire must not ship 8-byte doubles: float64
    arrays normalize to float32 on write, both ways, as in the JAX
    package."""
    chan, slave, close = _make_link(kind)
    try:
        chan.write_to_slave(np.arange(6, dtype=np.float64))
        got = slave.recv()
        assert got.dtype == np.float32
        assert chan.bytes_to_slave == 6 * 4
        slave.send(np.arange(6, dtype=np.float64))
        back = chan.read_on_master()
        assert back.dtype == np.float32
    finally:
        close()
    theirs, nbytes = _through(kind, np.arange(6, dtype=np.float64), "jax")
    assert (theirs.dtype, nbytes) == (got.dtype, 6 * 4)
    np.testing.assert_array_equal(got, theirs)


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_codec_decodes_to_float32_on_read(kind):
    chan, slave, close = _make_link(kind, "fp16")
    try:
        chan.write_to_slave(np.arange(8, dtype=np.float32))
        got = slave.recv()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.arange(8, dtype=np.float32))
        slave.send(got)
        back = chan.read_on_master()
        assert back.dtype == np.float32
    finally:
        close()
    theirs, _ = _through(kind, np.arange(8, dtype=np.float32), "jax", wire_dtype="fp16")
    np.testing.assert_array_equal(got, theirs)


def test_tcp_frame_bytes_track_real_wire():
    """TCP additionally accounts what ACTUALLY crossed the socket —
    framing + pickle overhead on top of the canonical payload bytes."""
    chan, slave, close = _make_link("tcp")
    try:
        chan.write_to_slave(_payload())
        slave.recv()
        assert chan.frame_bytes_to_slave > chan.bytes_to_slave > 0
    finally:
        close()


# ---------------------------------------------------------------------------
# shm-specific: segment hygiene and the inline-overflow fallback
# ---------------------------------------------------------------------------


def _shm_segments():
    try:
        return set(os.listdir("/dev/shm"))
    except (FileNotFoundError, NotADirectoryError):  # pragma: no cover
        pytest.skip("no /dev/shm on this platform")


def test_shm_close_unlinks_every_segment():
    """The shm link creates its rings on open and must leave NOTHING in
    /dev/shm after close — the master owns unlink, the slave only
    detaches."""
    before = _shm_segments()
    chan, slave, close = _make_link("shm")
    try:
        chan.write_to_slave(_payload())
        slave.recv()
        assert _shm_segments() - before  # the rings are real OS segments
    finally:
        close()
    assert _shm_segments() - before == set()


def test_shm_array_larger_than_ring_falls_back_inline():
    """An array that cannot fit the ring ships inline on the control
    socket instead of deadlocking the ring writer — and the canonical
    accounting is unchanged either way."""
    big = np.arange(4096, dtype=np.float32)  # 16 KiB > the 4 KiB ring
    small = np.ones((8, 8), np.float32)
    chan, slave, close = _make_link("shm", ring_bytes=4096)
    try:
        chan.write_to_slave({"big": big, "small": small})
        got = slave.recv()
        np.testing.assert_array_equal(got["big"], big)
        np.testing.assert_array_equal(got["small"], small)
        assert chan.bytes_to_slave == big.nbytes + small.nbytes + 2 * 8
        slave.send(big * 2.0)
        np.testing.assert_array_equal(chan.read_on_master(), big * 2.0)
    finally:
        close()


def test_shm_sustains_many_frames_through_small_ring():
    """Ring reuse under wraparound: far more traffic than the ring's
    capacity crosses intact and in order once the consumer releases."""
    chan, slave, close = _make_link("shm", ring_bytes=1 << 14)
    try:
        msgs = [
            np.full((32, 16), float(i), np.float32)  # 2 KiB each, 64 total
            for i in range(64)
        ]

        def _pump():
            for m in msgs:
                chan.write_to_slave(m)

        t = threading.Thread(target=_pump)
        t.start()
        for m in msgs:
            np.testing.assert_array_equal(slave.recv(), m)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        close()


# ---------------------------------------------------------------------------
# cluster-level conformance: the same protocol over either wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_cluster_forward_matches_reference(kind):
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(3, 3, 3, 9)).astype(np.float32)
    c, jc = clusters([1.0, 1.0], transport=kind)
    try:
        c.probe_times = jc.probe_times = [1.0, 1.0]
        got = c.conv_forward(x, w)
        np.testing.assert_allclose(got, ref_conv(x, w), atol=1e-4)
        np.testing.assert_allclose(got, jc.conv_forward(x, w), atol=1e-4)
    finally:
        c.shutdown()
        jc.shutdown()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_slave_error_propagates_not_hangs(kind):
    """A slave-side exception ships back as a SlaveError and re-raises
    on the master instead of hanging the gather — on either wire.
    (w=None with no cached shard is a guaranteed slave-side KeyError.)"""
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport=kind)
    try:
        x = np.zeros((1, 4, 4, 2), np.float32)
        c.sockets[0].write_to_slave(("conv", (x, None)))
        out = c.sockets[0].read_on_master()
        with pytest.raises(RuntimeError, match="slave device 1 failed"):
            c._check_result(out)
        # the link survives the error: the next op still works
        w = np.ones((1, 1, 2, 3), np.float32)
        c.sockets[0].write_to_slave(("conv", (x, w)))
        assert c._check_result(c.sockets[0].read_on_master()).shape == (1, 4, 4, 3)
    finally:
        c.shutdown()


@pytest.mark.parametrize("kind", ["tcp", "shm"])
def test_subprocess_probe_measures_link_bandwidth(kind):
    """probe() on a subprocess transport fills the planning bandwidths
    from a real echo round-trip — the measured link replaces the knob.
    On shm the probe times the RING."""
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport=kind)
    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=4,
                batch=2, repeats=1)
        assert all(b is not None and b > 0 for b in c.measured_bandwidths)
        assert c.bandwidths == c.measured_bandwidths
        # the echo probes are not protocol traffic: neither counter family
        # may retain their megabytes
        assert all(s.total_bytes < 1 << 20 for s in c.sockets)
        assert all(
            s.frame_bytes_to_slave + s.frame_bytes_to_master < 1 << 20
            for s in c.sockets
        )
        # RE-probing refreshes the measurement instead of mistaking the
        # first one for a user override
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=4,
                batch=2, repeats=1)
        assert c.bandwidths == c.measured_bandwidths
        # the comm-aware Eq. 1 consumes it without blowing up
        counts = c.shares_for(16, unit_bytes=1024.0, layer_flops=1e6)
        assert counts.sum() == 16
    finally:
        c.shutdown()


def test_tcp_explicit_bandwidth_overrides_measurement():
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport="tcp",
                      bandwidth_mbps=25.0)
    try:
        c.probe(image_size=8, in_channels=3, kernel_size=3, num_kernels=4,
                batch=2, repeats=1)
        assert c.bandwidths == [25.0]
    finally:
        c.shutdown()


@pytest.mark.parametrize("kind", ["tcp", "shm"])
@pytest.mark.parametrize("partition", ["kernel", "spatial", "auto"])
def test_subprocess_train_chain_matches_single_device_vjp(partition, kind, monkeypatch):
    """The acceptance bar: the pipelined fwd+bwd train chain over REAL
    subprocess slaves equals the single-device VJP and the JAX
    package's cluster on the same wire, on every axis.  On the kernel
    axis one slave process runs the port's ``torch:cpu`` backend (a
    torch import costs each such spawn ~3 s here, so the other axes
    keep ``numpy`` slaves)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the torch:cpu slave's threads
    x, w1, w2, g = data()
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters(
        [1.0, 1.0, 1.0],
        slaves=["numpy", "torch:cpu"] if partition == "kernel" else None,
        transport=kind,
        partition=partition, pipeline=True, microbatches=3,
        # finite links exercise auto's comm-extended prediction; tcp
        # never delays anything, this only feeds the planner
        bandwidth_mbps=50.0,
    )
    try:
        c.probe_times = jc.probe_times = [1.0, 1.0, 1.0]
        check(train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


@pytest.mark.parametrize("kind", ["tcp", "shm"])
def test_subprocess_orderly_shutdown_reaps_subprocesses(kind):
    c = HeteroCluster([1.0, 1.0, 1.0], port_backends(3), transport=kind)
    try:
        c.probe_times = [1.0, 1.0, 1.0]
        x = np.zeros((2, 6, 6, 2), np.float32)
        w = np.ones((3, 3, 2, 4), np.float32)
        c.conv_forward(x, w)
    finally:
        c.shutdown()
    assert [p.returncode for p in c.procs] == [0, 0]
    c.shutdown()  # idempotent


@pytest.mark.parametrize("kind", ["tcp", "shm"])
def test_subprocess_shutdown_after_master_exception_reaps(kind):
    """A protocol error on the master must not leak slave processes:
    shutdown() after the exception still ends them cleanly."""
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport=kind)
    try:
        x = np.zeros((1, 4, 4, 2), np.float32)
        c.sockets[0].write_to_slave(("conv", (x, None)))  # slave KeyError
        with pytest.raises(RuntimeError, match="failed"):
            c._check_result(c.sockets[0].read_on_master())
    finally:
        c.shutdown()
    assert [p.returncode for p in c.procs] == [0]
