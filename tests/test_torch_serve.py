"""The port's serving slice, end to end, against the JAX package.

- Serve parity: one ``init_cnn`` parameter tree (JAX package) is carried
  across with ``repro_torch.convert`` and served twice on the same
  requests — by the JAX package's ``ClusterServer`` over a numpy /
  Pallas-interpret / numpy cluster, and by the port's over three
  ``torch:cpu`` devices.  The outputs agree to atol 1e-4 (fp32, two
  conv layers and a 32-wide head: only summation orders differ).
- Every partition axis of the port's cluster matches its single-device
  chain, forward (serving) and backward (the protocol's VJP ops).
- The port's CLI serves on the CPU when asked, trains the two-tier
  ``--groups`` topology on the CPU when asked, and never falls back to
  the CPU when asked for the card; the slave CLI joins as a sub-master.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CNNConfig
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro.models.cnn import init_cnn
from repro.serve.server import ClusterServer as JaxClusterServer
from repro_torch import convert
from repro_torch.core.backends import get_backend, numpy_conv, numpy_conv_vjp
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.launch.hetero import relu_pool, run_serve, serve_inputs
from repro_torch.serve.server import ClusterServer

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(c1=4, c2=8, image=8):
    cfg = CNNConfig(arch_id=f"cifar_cnn_{c1}_{c2}", c1_kernels=c1,
                    c2_kernels=c2, image_size=image)
    return jax.tree.map(np.asarray, init_cnn(jax.random.key(0), cfg))


def _requests(n, image=8, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((image, image, 3)).astype(np.float32)
            for _ in range(n)]


def _serve(server_cls, cluster, kernels, fc, images, max_batch=4):
    cluster.probe_times = [1.0] * len(cluster.slowdowns)
    server = server_cls(
        cluster, kernels, between=[relu_pool, relu_pool],
        head=lambda z: z.reshape(z.shape[0], -1) @ fc, max_batch=max_batch,
    )
    try:
        with server:
            resps = [f.result(timeout=300) for f in
                     [server.submit(x) for x in images]]
    finally:
        cluster.shutdown()
    assert [r.status for r in resps] == ["ok"] * len(images)
    return np.stack([r.output for r in resps])


def _single_device_chain(images, kernels, fc):
    backend = get_backend("torch:cpu")
    z = np.stack(images)
    for w in kernels:
        z = relu_pool(backend.conv(z, w))
    return z.reshape(z.shape[0], -1) @ fc


def test_convert_keeps_names_layouts_and_values():
    params = _params()
    tree = convert.params_from_numpy(params, "cpu")
    assert set(tree) == {"conv1", "conv2", "fc"}
    for layer in tree:
        for name, leaf in tree[layer].items():
            assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
            np.testing.assert_array_equal(leaf.numpy(), params[layer][name])
    kernels, fc = convert.serve_weights(tree)
    kernels_np, fc_np = convert.serve_weights(params)
    assert [k.shape for k in kernels] == [(5, 5, 3, 4), (5, 5, 4, 8)]
    assert fc.shape == (2 * 2 * 8, 10)
    for a, b in zip(kernels + [fc], kernels_np + [fc_np]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_serve_parity_with_jax_cluster_server():
    """The same network and requests through both packages' serve lanes."""
    kernels, fc = convert.serve_weights(_params())
    images = _requests(6)
    want = _serve(
        JaxClusterServer,
        JaxHeteroCluster([1.0, 1.0, 1.5],
                         backends=["numpy", "pallas:interpret", "numpy"],
                         pipeline=True, microbatches=2),
        kernels, fc, images,
    )
    got = _serve(
        ClusterServer,
        HeteroCluster([1.0, 1.0, 1.5], backends=["torch:cpu"] * 3,
                      pipeline=True, microbatches=2),
        kernels, fc, images,
    )
    assert got.shape == (6, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("partition", ["kernel", "spatial", "batch", "auto"])
def test_serve_every_axis_matches_single_device_chain(partition):
    kernels, fc = convert.serve_weights(_params())
    images = _requests(5, seed=4)
    got = _serve(
        ClusterServer,
        HeteroCluster([1.0, 1.0, 1.5], backends=["torch:cpu", "numpy", "torch:cpu"],
                      pipeline=True, microbatches=2, partition=partition,
                      bandwidth_mbps=100.0),
        kernels, fc, images, max_batch=3,
    )
    np.testing.assert_allclose(got, _single_device_chain(images, kernels, fc),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("partition", ["kernel", "spatial", "batch"])
def test_cluster_backward_on_torch_backend_matches_vjp(partition):
    """The protocol's backward ops ("bwd"/"sbwd") on ``torch:cpu``
    devices reassemble the single-device VJP on every axis."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 6)) * 0.1).astype(np.float32)
    g = rng.standard_normal((4, 8, 8, 6)).astype(np.float32)
    c = HeteroCluster([1.0, 1.0, 1.0], backends=["torch:cpu"] * 3,
                      partition=partition)
    try:
        c.probe_times = [1.0, 1.0, 1.0]
        y = c.conv_forward(x, w)
        dx, dw = c.conv_backward(x, w, g)
    finally:
        c.shutdown()
    dx_want, dw_want = numpy_conv_vjp(x, w, g)
    np.testing.assert_allclose(y, numpy_conv(x, w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dx, dx_want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dw, dw_want, atol=1e-3, rtol=1e-5)


def test_run_serve_on_cpu_draws_the_jax_lanes_inputs():
    """run_serve's numpy draws are the JAX lane's (same seed, same
    order), and its outputs are the single-device chain's."""
    rec, outputs = run_serve([1.0, 1.0], device="cpu", c1=4, c2=8,
                             requests=3, image_size=8, seed=5)
    assert rec["all_ok"] and rec["backends"] == ["torch:cpu", "torch:cpu"]
    assert sum(rec["kernels_per_device"]["c2"]) == 8
    weights, fc, images = serve_inputs(5, 4, 8, 8, 3)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(
        weights[0], rng.standard_normal((5, 5, 3, 4)).astype(np.float32) * 0.1)
    np.testing.assert_allclose(np.stack(outputs),
                               _single_device_chain(images, weights, fc),
                               atol=ATOL, rtol=0)


def test_serve_over_tcp_spawns_the_ports_slave_processes(monkeypatch):
    """tcp slaves are ``python -m repro_torch.core.cluster.protocol``
    subprocesses that resolve the port's ``torch:cpu`` backend."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the slaves' torch threads
    kernels, fc = convert.serve_weights(_params())
    images = _requests(4)
    c = HeteroCluster([1.0, 1.0], backends=["torch:cpu", "torch:cpu"],
                      transport="tcp", pipeline=True)
    assert "repro_torch.core.cluster.protocol" in c._slave_cmd(1, 1.0, "torch:cpu")
    got = _serve(ClusterServer, c, kernels, fc, images)
    np.testing.assert_allclose(got, _single_device_chain(images, kernels, fc),
                               atol=ATOL, rtol=0)


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hetero", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )


def test_cli_serves_on_cpu():
    r = _cli("--serve", "--device", "cpu", "--requests", "4", "--c1", "4",
             "--c2", "8", "--image-size", "8")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "statuses=['ok']" in r.stdout


def test_cli_refuses_training_modes():
    """The two-tier training topology trains on the CPU when asked (the
    flat training modes: tests/test_torch_train.py); on the card without
    one it refuses before any sub-master starts."""
    r = _cli("--train-pipeline", "--device", "cpu", "--groups", "2x2", "--c1", "4",
             "--c2", "8", "--batch", "4", "--steps", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "topology=2x2" in r.stdout and "2 steps in" in r.stdout
    assert "losses=[2.632, 1.6797]" in r.stdout  # the flat CLI's losses
    if not torch.cuda.is_available():
        r = _cli("--train-pipeline", "--groups", "2x2", "--c1", "4", "--c2", "8")
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert "devices:" not in r.stdout


def test_cli_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = _cli("--serve", "--requests", "2", "--c1", "4", "--c2", "8")
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert "requests in" not in r.stdout


@pytest.mark.parametrize("name", ["cuda", "torch:cuda"])
def test_cuda_backends_without_a_card_raise(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HeteroCluster([1.0, 1.0], backends=["numpy", name])


def _slave(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.core.cluster.protocol",
         "--host", "127.0.0.1", "--port", "9", "--connect-timeout-s", "1",
         *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("entry", ["cluster", "admit", "slave_cli"])
def test_default_backend_is_the_card_and_refuses_without_one(entry):
    """A cluster, a device admitted to it and a slave process all run
    on the card unless asked for a CPU backend; without a card each
    refuses, before any slave starts or a slave joins."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    if entry == "slave_cli":
        r = _slave()
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        return
    if entry == "cluster":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HeteroCluster([1.0, 1.0])
        return
    c = HeteroCluster([1.0], backends=["numpy"])
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            c.admit()
        assert c.n_slaves == 0 and c.backends == ["numpy"]
    finally:
        c.shutdown()


def test_slave_cli_refuses_sub_master_mode():
    """The slave CLI with ``--group-*`` flags joins a waiting master as a
    sub-master of a two-device group and answers its probe with the
    group's aggregate Eq. 1 time."""
    c = HeteroCluster([1.0], backends=["numpy"], transport="tcp")
    slave = None
    try:
        c.probe_times = [1.0]
        host, port = c.listen_address
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   REPRO_CLUSTER_AUTH=c.auth_token_hex)
        slave = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.cluster.protocol",
             "--host", host, "--port", str(port), "--backend", "numpy",
             "--group-slowdowns", "1,1", "--group-backends", "numpy,numpy"],
            env=env,
        )
        dev = c.admit(spawn=False, timeout_s=60.0)
        assert c.hello_meta[dev]["group"] == {"size": 2, "bandwidth_mbps": None}
        assert c.backends == ["numpy", "numpy"]
        assert len(c.probe_times) == 2 and c.probe_times[1] > 0
        x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
        w = np.random.default_rng(1).normal(size=(3, 3, 3, 9)).astype(np.float32)
        np.testing.assert_allclose(c.conv_forward(x, w), numpy_conv(x, w),
                                   atol=ATOL, rtol=0)
    finally:
        c.shutdown()
        if slave is not None:
            assert slave.wait(timeout=30) == 0


def test_torch_backend_conv_and_vjp_match_numpy():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 4, 6)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    b = get_backend("torch:cpu")
    assert get_backend("torch") is not b and get_backend("torch").device.type == "cpu"
    np.testing.assert_allclose(b.conv(x, w), numpy_conv(x, w), atol=ATOL, rtol=0)
    for got, want in zip(b.conv_vjp(x, w, g), numpy_conv_vjp(x, w, g)):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)
