"""Twin of tests/test_elastic.py over ``repro_torch``: evict/admit on a
live port cluster keeps plans coherent and numerics exact on every
partition axis, over the in-proc and tcp transports.

Each reference case runs here.  After each membership change the next
plan re-runs the comm-aware Eq. 1 over exactly the current device set,
and a full pipelined fwd+bwd train chain matches the single-device VJP
and the JAX package's cluster, which goes through the same evict/admit
sequence on the same inputs (rtol 1e-4, atol 1e-3).  Also the
membership bookkeeping (stable ids, aligned lists, the same Eq. 1
counts as the JAX package), the elastic constructor's validation, the
join secret, stray connections and the admit timeout (the reference's
10 s bound).  Port clusters name their backends (``torch:cpu`` master,
``numpy`` slaves).
"""
import os
import socket
import subprocess
import time

import numpy as np
import pytest

from _torch_cluster_parity import (
    check,
    clusters,
    data,
    port_backends,
    ref_conv,
    single_device_grads,
    slave_cmd,
    slave_env,
    train_step,
)
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro_torch.core.cluster.plans import check_plan, strip_plan
from repro_torch.core.master_slave import HeteroCluster

TRANSPORTS = ("inproc", "tcp")
AXES = ("kernel", "spatial", "auto")


def _check_all_plans(c, x, w):
    """Fresh plans on both axes satisfy the invariants for the CURRENT
    membership."""
    n_dev = c.n_slaves + 1
    kp = c.plan_conv(x.shape, w, "train", partition="kernel")
    check_plan(kp, w.shape[-1], n_dev)
    sp = c.plan_conv(x.shape, w, "train", partition="spatial")
    check_plan(sp, x.shape[1], n_dev)
    # halos recomputed for the current counts, not inherited
    rows, halos = strip_plan(x.shape[1], w.shape[0], sp.counts)
    assert sp.rows == rows and sp.halos == halos


@pytest.mark.parametrize("kind", TRANSPORTS)
@pytest.mark.parametrize("partition", AXES)
def test_evict_admit_train_chain_matches_vjp(kind, partition):
    """The conformance bar: train-chain numerics before, after an evict
    and after an admit — every axis, both wires — against the
    single-device VJP and the JAX package's cluster through the same
    membership changes.  Finite planning bandwidth exercises the
    comm-aware Eq. 1 re-run on each membership."""
    x, w1, w2, g = data()
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters(
        [1.0, 1.0, 1.0], transport=kind, partition=partition,
        pipeline=True, microbatches=3, bandwidth_mbps=50.0,
    )
    try:
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
        check(train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g), want)
        for cl in (c, jc):
            cl.evict(cl.slave_ids[-1])
            assert cl.n_slaves == 1
            _check_all_plans(cl, x, w1)
        check(train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g), want)
        for cl in (c, jc):
            dev = cl.admit(slowdown=1.0, backend="numpy", bandwidth_mbps=50.0,
                           probe_time=1.0)
            assert dev not in (None, cl.slave_ids[0]) and cl.n_slaves == 2
            _check_all_plans(cl, x, w1)
        assert c.slave_ids == jc.slave_ids
        check(train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


@pytest.mark.parametrize("kind", TRANSPORTS)
@pytest.mark.parametrize("partition", ("kernel", "spatial", "batch"))
def test_graceful_evict_mid_step_drains_on_survivors(partition, kind):
    """evict() while ops are in flight: the live plans keep naming the
    retiree, the master absorbs its shards (its channels, strips or
    rows), the step's numerics hold, and the NEXT plans cover only the
    survivors."""
    x, w1, w2, g = data(seed=6)
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters([1.0, 1.0, 1.0], transport=kind, partition=partition,
                     pipeline=True, microbatches=3)
    try:
        results = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            results.append(train_step(
                cl, x, w1, w2, g,
                first_between=lambda cl=cl, dev=cl.slave_ids[0]: cl.evict(dev),
            ))
            assert cl.n_slaves == 1
            assert cl.timing.recompute_s > 0.0  # the master really absorbed work
            assert not cl.failures  # graceful: an evict is not a failure
            _check_all_plans(cl, x, w1)
        check(results[0], results[1], want)
    finally:
        c.shutdown()
        jc.shutdown()


def test_membership_bookkeeping_stays_aligned():
    """Stable ids never recycle; every per-slot list tracks membership
    through an evict/admit churn; Eq. 1 over the new membership gives
    the JAX package's counts."""
    c, jc = clusters([1.0, 1.0, 1.5], bandwidth_mbps=[25.0, 50.0])
    try:
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.5]
            assert cl.slave_ids == [1, 2]
            cl.evict(1)
            assert cl.slave_ids == [2]
            assert cl.slowdowns == [1.0, 1.5]
            assert cl.bandwidths == [50.0]
            assert cl.probe_times == [1.0, 1.5]
            dev = cl.admit(slowdown=2.0, backend="numpy", bandwidth_mbps=10.0,
                           probe_time=2.0)
            assert dev == 3  # id 1 is never reused
            assert cl.slave_ids == [2, 3]
            assert cl.slowdowns == [1.0, 1.5, 2.0]
            assert cl.bandwidths == [50.0, 10.0]
            assert cl.probe_times == [1.0, 1.5, 2.0]
        assert c.backends == ["torch:cpu", "numpy", "numpy"]
        # Eq. 1 over the new membership: every unit lands somewhere
        counts = c.shares_for(16)
        assert counts.sum() == 16 and len(counts) == 3
        # the 2.0x slave gets the smallest share (largest probe time)
        assert counts[2] == counts.min()
        np.testing.assert_array_equal(counts, jc.shares_for(16))
    finally:
        c.shutdown()
        jc.shutdown()


def test_evict_unknown_device_raises():
    c = HeteroCluster([1.0, 1.0], port_backends(2))
    try:
        with pytest.raises(KeyError, match="no live slave"):
            c.evict(99)
        c.evict(1)
        with pytest.raises(KeyError, match="no live slave"):
            c.evict(1)  # already gone
    finally:
        c.shutdown()


def test_elastic_constructor_validation():
    with pytest.raises(ValueError, match="transport='tcp'"):
        HeteroCluster([1.0], ["torch:cpu"], expected_slaves=1)  # inproc can't join
    with pytest.raises(ValueError, match="ONLY the master"):
        HeteroCluster([1.0, 1.5], port_backends(2), transport="tcp",
                      expected_slaves=1)
    with pytest.raises(ValueError, match="heartbeat_s"):
        HeteroCluster([1.0, 1.0], port_backends(2), heartbeat_s=0.0)
    with pytest.raises(ValueError, match="spawn=False"):
        c = HeteroCluster([1.0, 1.0], port_backends(2))
        try:
            c.admit(spawn=False)
        finally:
            c.shutdown()


def test_expected_slaves_requires_auth_token():
    """An unauthenticated waiting listener would hand any process that
    can reach it pickle-powered code execution: refuse to start."""
    env_had = os.environ.pop("REPRO_CLUSTER_AUTH", None)
    try:
        with pytest.raises(RuntimeError, match="REPRO_CLUSTER_AUTH"):
            HeteroCluster([1.0], ["torch:cpu"], transport="tcp", expected_slaves=1)
    finally:
        if env_had is not None:
            os.environ["REPRO_CLUSTER_AUTH"] = env_had


def test_stray_connections_do_not_abort_join():
    """A port scanner hitting the listener — connect-and-slam, wrong
    token — is rejected and SKIPPED; the real joiner behind it in the
    backlog still gets in.  One bad peer must never abort membership."""
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport="tcp")
    slave = None
    try:
        c.probe_times = [1.0, 1.0]
        host, port = c.listen_address
        junk1 = socket.create_connection((host, port))
        junk1.close()  # EOF before any auth bytes
        junk2 = socket.create_connection((host, port))
        junk2.sendall(b"\x00" * 32)  # wrong token
        slave = subprocess.Popen(
            slave_cmd("repro_torch", "--host", host, "--port", str(port),
                      "--backend", "numpy"),
            env=slave_env(c.auth_token_hex),
        )
        dev = c.admit(spawn=False, timeout_s=60.0, probe_time=1.0)
        junk2.close()
        assert c.n_slaves == 2 and dev in c.slave_ids
    finally:
        c.shutdown()
        if slave is not None:
            try:
                assert slave.wait(timeout=10) == 0
            finally:
                if slave.poll() is None:
                    slave.kill()
                    slave.wait(timeout=10)


def test_admit_timeout_raises_not_hangs():
    """admit(spawn=False) with nobody joining fails loudly and promptly."""
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport="tcp")
    try:
        t0 = time.monotonic()
        with pytest.raises((TimeoutError, OSError)):
            c.admit(spawn=False, timeout_s=1.0)
        assert time.monotonic() - t0 < 10.0
        assert c.n_slaves == 1  # membership untouched
    finally:
        c.shutdown()


def test_admit_external_join_into_spawned_cluster():
    """admit(spawn=False): a hand-launched slave joins a RUNNING
    spawn-mode cluster mid-life, using the cluster's own join secret
    (auth_token_hex) — grow-while-training."""
    c = HeteroCluster([1.0, 1.0], port_backends(2), transport="tcp")
    slave = None
    try:
        c.probe_times = [1.0, 1.0]
        host, port = c.listen_address
        slave = subprocess.Popen(
            slave_cmd("repro_torch", "--host", host, "--port", str(port),
                      "--backend", "numpy", "--slowdown", "1.0"),
            env=slave_env(c.auth_token_hex),
        )
        dev = c.admit(spawn=False, timeout_s=60.0, probe_time=1.0)
        assert dev == 2 and c.n_slaves == 2
        assert c.backends == ["torch:cpu", "numpy", "numpy"]
        # the joiner serves real ops: the conv equals the JAX package's
        # single-device conv and its cluster's over the same three devices
        x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
        w = np.random.default_rng(1).normal(size=(3, 3, 3, 9)).astype(np.float32)
        y = c.conv_forward(x, w)
        assert y.shape == (2, 8, 8, 9)
        np.testing.assert_allclose(y, ref_conv(x, w), atol=1e-4)
        jc = JaxHeteroCluster([1.0, 1.0, 1.0])
        try:
            jc.probe_times = [1.0, 1.0, 1.0]
            np.testing.assert_allclose(y, jc.conv_forward(x, w), atol=1e-4)
        finally:
            jc.shutdown()
    finally:
        c.shutdown()
        if slave is not None:
            try:
                assert slave.wait(timeout=10) == 0
            finally:
                if slave.poll() is None:
                    slave.kill()
                    slave.wait(timeout=10)
