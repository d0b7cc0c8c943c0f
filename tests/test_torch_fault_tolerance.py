"""Twin of tests/test_fault_tolerance.py over ``repro_torch``: faults
injected into the port's elastic cluster runtime.

Each reference case runs here.  A TCP slave SIGKILLed in the middle of
a pipelined train step is detected within the heartbeat timeout,
auto-evicted, its in-flight shards recomputed by the master, and the
step completes on the survivors; a SIGSTOPped slave trips the heartbeat
deadline; a slave dead before the step is found by the first scatter;
a slave launched by hand (``python -m
repro_torch.core.cluster.protocol``) joins a waiting cluster.  The JAX
package's cluster runs each scenario the same way on the same inputs
(its tests' way), and the port's gradients match it and the
single-device VJP (rtol 1e-4, atol 1e-3); the deadlines and wall-clock
bounds are the reference's.  Port clusters name their backends
(``torch:cpu`` master, ``numpy`` slaves).
"""
import os
import signal
import socket
import struct
import subprocess
import threading
import time

import numpy as np
import pytest

from _torch_cluster_parity import (
    check,
    clusters,
    data,
    free_port,
    single_device_grads,
    slave_cmd,
    slave_env,
    train_step,
)
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro_torch.core.cluster.transport import (
    SlaveLost,
    TCPListener,
    TCPSlaveEndpoint,
    TCPTransport,
)
from repro_torch.core.master_slave import HeteroCluster


def _faulted_step(c, x, w1, w2, g, fault):
    """``train_step`` with ``fault()`` fired mid-step; returns the result
    and the monotonic time the fault fired."""
    fired = {}

    def first():
        fired["t"] = time.monotonic()
        fault()

    return train_step(c, x, w1, w2, g, first_between=first), fired.get("t")


def test_sigkill_mid_step_recovers_on_survivors():
    """SIGKILL one TCP slave while a pipelined train step has ops in
    flight: the loss is detected within the heartbeat timeout, the
    victim is auto-evicted, the master absorbs its shards, and the
    step's gradients still match.  The NEXT step re-partitions over the
    survivors and matches too — in both packages."""
    x, w1, w2, g = data()
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters(
        [1.0, 1.0, 1.0], transport="tcp", pipeline=True, microbatches=3,
        heartbeat_s=2.0,  # timeout 6s; a SIGKILL EOF lands far sooner
    )
    try:
        results = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            victim_proc = cl.procs[0]
            victim_dev = cl.slave_ids[0]
            res, t_kill = _faulted_step(cl, x, w1, w2, g, victim_proc.kill)
            # detection: recorded, attributed, and within the deadline
            assert len(cl.failures) == 1
            assert cl.failures[0]["device"] == victim_dev
            assert t_kill is not None
            assert cl.failures[0]["t_detected"] - t_kill < cl.heartbeat_timeout_s
            # survivor-only membership, victim reaped, recovery work logged
            assert cl.slave_ids == [2] and cl.n_slaves == 1
            assert victim_proc.returncode is not None
            assert cl.timing.recompute_s > 0.0
            # the next step re-partitions on the survivors
            plan = cl.plan_conv(x.shape, w2, "train")
            assert len(plan.counts) == 2 and int(plan.counts.sum()) == w2.shape[-1]
            results.append((res, train_step(cl, x, w1, w2, g)))
        (res, res2), (jres, jres2) = results
        check(res, jres, want)
        check(res2, jres2, want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_sigstop_wedged_slave_trips_heartbeat_deadline():
    """A SIGSTOPped slave keeps its socket open — only the heartbeat
    deadline can unmask it.  The step must still complete correctly,
    within the timeout + the step's own work."""
    x, w1, w2, g = data(seed=7)
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters(
        [1.0, 1.0, 1.0], transport="tcp", pipeline=True, microbatches=3,
        heartbeat_s=0.25,  # timeout 0.75s: keep the blocked wait short
    )
    victims = []
    try:
        results = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            victim = cl.procs[0]
            victims.append(victim)
            res, t_stop = _faulted_step(
                cl, x, w1, w2, g,
                lambda v=victim: os.kill(v.pid, signal.SIGSTOP),
            )
            assert len(cl.failures) == 1
            assert "deadline" in cl.failures[0]["error"]
            # detected via the heartbeat clock, not EOF — and within it
            # (plus scheduling slack: the master only reads at gathers)
            assert cl.failures[0]["t_detected"] - t_stop < cl.heartbeat_timeout_s + 2.0
            assert cl.slave_ids == [2]
            results.append(res)
        check(results[0], results[1], want)
    finally:
        c.shutdown()
        jc.shutdown()
        # _remove_slot SIGKILLed and reaped the stopped processes
        for victim in victims:
            assert victim.returncode is not None


def _link(heartbeat_timeout_s):
    """(master channel, slave endpoint box, listener) over a real
    localhost socket, the endpoint connected from a thread."""
    listener = TCPListener()
    box = {}

    def _connect():
        box["ep"] = TCPSlaveEndpoint(listener.host, listener.port)

    t = threading.Thread(target=_connect)
    t.start()
    chan = TCPTransport(listener.accept(timeout_s=10),
                        heartbeat_timeout_s=heartbeat_timeout_s)
    t.join(timeout=10)
    assert not t.is_alive()
    return chan, box["ep"], listener


def test_wedged_link_raises_slave_lost_within_deadline():
    """Transport-level deadline: a link whose peer never beats raises
    SlaveLost from read_on_master within the configured timeout."""
    chan, ep, listener = _link(0.6)
    try:
        t0 = time.monotonic()
        with pytest.raises(SlaveLost, match="deadline"):
            chan.read_on_master()
        elapsed = time.monotonic() - t0
        assert 0.5 <= elapsed < 5.0, elapsed
    finally:
        chan.close()
        ep.close()
        listener.close()


def test_mid_frame_stall_trips_deadline():
    """select() only promises the FIRST byte of a frame: a peer that
    stalls MID-frame must still trip the armed deadline instead of
    hanging a timeout-less recv forever."""
    listener = TCPListener()
    box = {}

    def _connect():
        box["s"] = socket.create_connection((listener.host, listener.port))

    t = threading.Thread(target=_connect)
    t.start()
    chan = TCPTransport(listener.accept(timeout_s=10), heartbeat_timeout_s=0.6)
    t.join(timeout=10)
    assert not t.is_alive()
    peer = box["s"]
    try:
        # header promises 1 MB; only 1 KB ever arrives
        peer.sendall(struct.pack(">Q", 1 << 20) + b"x" * 1024)
        t0 = time.monotonic()
        with pytest.raises(SlaveLost, match="mid-frame"):
            chan.read_on_master()
        assert 0.5 <= time.monotonic() - t0 < 5.0
    finally:
        chan.close()
        peer.close()
        listener.close()


def test_heartbeats_keep_slow_link_alive():
    """The inverse: a peer that beats but answers slowly must NOT be
    declared lost — heartbeats refresh the deadline."""
    chan, ep, listener = _link(0.6)
    try:
        ep.start_heartbeat(0.15)

        def _slow_reply():
            time.sleep(1.5)  # >2x the deadline, bridged by heartbeats
            ep.send(("done", np.arange(3, dtype=np.float32)))

        threading.Thread(target=_slow_reply, daemon=True).start()
        tag, arr = chan.read_on_master()
        assert tag == "done"
        np.testing.assert_array_equal(arr, np.arange(3, dtype=np.float32))
        # heartbeats are liveness, not protocol traffic: only the real
        # reply may be accounted
        assert chan.bytes_to_master == arr.nbytes + 8
    finally:
        chan.close()
        ep.close()
        listener.close()


def test_slave_killed_between_steps_recovers():
    """A slave dead BEFORE the step starts (no in-flight ops): the
    first scatter/gather of the next step discovers it, recovery kicks
    in, and the step completes correctly on the survivors."""
    x, w1, w2, g = data(seed=9)
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters([1.0, 1.0, 1.0], transport="tcp", pipeline=True,
                     microbatches=3)
    try:
        results = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            cl.procs[1].kill()
            cl.procs[1].wait(timeout=10)
            results.append(train_step(cl, x, w1, w2, g))
            assert cl.slave_ids == [1]
            assert len(cl.failures) == 1 and cl.failures[0]["device"] == 2
        check(results[0], results[1], want)
    finally:
        c.shutdown()
        jc.shutdown()


def _hand_launched_run(module, cls, backends, x, w1, w2, g):
    """The reference scenario in one package: a slave started by hand
    (no --device: the master assigns one) BEFORE its master, which waits
    with expected_slaves=1, probes, and runs one train step.  Returns
    the step's result."""
    port = free_port()
    token = "ab" * 32
    # the slave starts FIRST and retries the connect until the master
    # binds — the two-terminal ordering an operator would actually hit
    slave = subprocess.Popen(
        slave_cmd(module, "--host", "127.0.0.1", "--port", str(port),
                  "--backend", "numpy", "--heartbeat-s", "0.25",
                  "--connect-timeout-s", "30"),
        env=slave_env(token),
    )
    os.environ["REPRO_CLUSTER_AUTH"] = token
    try:
        c = cls([1.0], *backends, transport="tcp", expected_slaves=1,
                listen_port=port, heartbeat_s=0.25, pipeline=True,
                microbatches=3)
        try:
            assert c.n_slaves == 1 and c.backends[1] == "numpy"
            probe = c.probe(image_size=8, in_channels=3, kernel_size=3,
                            num_kernels=4, batch=2, repeats=1)
            assert len(probe) == 2 and all(t > 0 for t in probe)
            assert c.measured_bandwidths[0] is not None
            res = train_step(c, x, w1, w2, g)
        finally:
            c.shutdown()
        assert slave.wait(timeout=10) == 0
        return res
    finally:
        os.environ.pop("REPRO_CLUSTER_AUTH", None)
        if slave.poll() is None:
            slave.kill()
            slave.wait(timeout=10)


def test_hand_launched_slave_joins_waiting_cluster():
    """The remote-host path over loopback: a slave started by hand via
    ``python -m repro_torch.core.cluster.protocol --host H --port P``
    joins a cluster waiting with expected_slaves=1 and serves a real
    train step, as the JAX package's slave does for its master."""
    x, w1, w2, g = data(seed=11)
    want = single_device_grads(x, w1, w2, g)
    res = _hand_launched_run("repro_torch", HeteroCluster, (["torch:cpu"],),
                             x, w1, w2, g)
    jres = _hand_launched_run("repro", JaxHeteroCluster, (), x, w1, w2, g)
    check(res, jres, want)
