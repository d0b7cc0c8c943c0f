"""Shared by the twins of the JAX package's cluster tests
(tests/test_torch_transport.py, test_torch_weight_cache.py,
test_torch_fault_tolerance.py, test_torch_elastic.py): the same numpy
inputs from a seed go through ``repro.core.master_slave.HeteroCluster``
and ``repro_torch``'s, and each result is held against the other and
against the single-device VJP at the reference tests' tolerance (rtol
1e-4, atol 1e-3).

The port's ``HeteroCluster`` and its slave CLI default to the ``cuda``
backend, which refuses to start without a card, so every port cluster
here names its backends: the master ``torch:cpu`` (the port's plain
PyTorch conv and autograd VJP) and the slaves ``numpy`` unless a test
asks for another (a spawned ``numpy`` slave never imports torch).  The
JAX package's clusters keep their own default, ``numpy`` everywhere.
"""
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro_torch.core.master_slave import HeteroCluster

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RTOL, ATOL = 1e-4, 1e-3


def port_backends(n: int, slaves=None) -> list:
    """``torch:cpu`` for the master, then ``slaves`` (default: ``numpy``
    for each of the ``n - 1``)."""
    return ["torch:cpu"] + list(slaves or ["numpy"] * (n - 1))


def clusters(slowdowns, *, slaves=None, **kw):
    """(the port's cluster, the JAX package's cluster) over the same
    slowdowns and options."""
    port = HeteroCluster(slowdowns, port_backends(len(slowdowns), slaves), **kw)
    try:
        return port, JaxHeteroCluster(slowdowns, **kw)
    except BaseException:
        port.shutdown()
        raise


def data(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(5, 8, 8, 3)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 3, 6)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 6, 9)).astype(np.float32)
    g = rng.normal(size=(5, 8, 8, 9)).astype(np.float32)
    return x, w1, w2, g


def ref_conv(x, w):
    return np.asarray(jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    ))


def single_device_grads(x, w1, w2, g):
    """jax.grad of sum(conv(relu(conv(x, w1)), w2) * g) on one device."""
    def f(x_, w1_, w2_):
        y = jax.nn.relu(jax.lax.conv_general_dilated(
            x_, w1_, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ))
        y2 = jax.lax.conv_general_dilated(
            y, w2_, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
        )
        return jnp.sum(y2 * g)

    return tuple(
        np.asarray(a)
        for a in jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2)
        )
    )


def train_step(c, x, w1, w2, g, first_between=None):
    """One pipelined fwd+bwd train chain of the two conv layers;
    ``first_between()`` (if given) runs once, from the first
    between-stage callback: MID-STEP, with conv and bwd ops still in
    flight on every link.  Returns the chain's ``TrainStepResult``."""
    fired = []

    def between(y):
        if first_between is not None and not fired:
            fired.append(True)
            first_between()
        mask = (y > 0).astype(np.float32)
        return np.maximum(y, 0.0), lambda gz: gz * mask

    slices = c.microbatch_slices(x.shape[0])

    def head(z, i):
        return None, g[slices[i]]

    return c.conv_train_chain(x, [w1, w2], [between, None], head)


def grads(res):
    return (res.dx, res.dw[0], res.dw[1])


def assert_matches(got, want, atol=ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


def check(port_res, jax_res, want):
    """The port's gradients against the single-device VJP and against
    the JAX package's cluster on the same inputs."""
    assert_matches(grads(port_res), want)
    assert_matches(grads(jax_res), want)
    assert_matches(grads(port_res), grads(jax_res))


def free_port() -> int:
    """A localhost port to rendezvous on: bind-and-release (the race
    window is negligible on a loopback)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def slave_env(token_hex: str) -> dict:
    """The environment of a hand-launched slave: the repo's src/ on the
    import path, the join secret, one intra-op thread."""
    env = os.environ.copy()
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    env["REPRO_CLUSTER_AUTH"] = token_hex
    env["OMP_NUM_THREADS"] = "1"
    return env


def slave_cmd(module: str, *args) -> list:
    """``python -m <module>.core.cluster.protocol`` with ``args``."""
    return [sys.executable, "-m", f"{module}.core.cluster.protocol", *args]
