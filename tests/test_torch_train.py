"""The port's training slice against the JAX package, on the CPU.

One ``init_cnn`` parameter tree (JAX package) is carried across with
``repro_torch.convert`` and the same numpy batch goes through both
packages:

- the CNN's layers and loss (``local_response_norm``, ``max_pool``,
  ``apply_dense``, ``cnn_forward``, ``cnn_loss``) agree to atol 1e-5;
- ``synthetic_cifar_batches`` yields the same arrays for a seed;
- the port's ``make_cluster_train_step`` on ``torch:cpu``/``numpy``
  devices, on every partition axis, gives the JAX cluster step's and the
  JAX single-device ``value_and_grad`` SGD step's params (atol 1e-4)
  and loss (atol 1e-5), tests/test_train_pipeline.py's tolerances;
- the ``--pipeline`` step (``make_distributed_conv``) gives the JAX
  one's with a numpy master (atol 1e-4);
- the port's CLI trains on the CPU when asked, refuses the card without
  one (the two-tier ``--groups`` run: tests/test_torch_hierarchy.py).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CNNConfig as JaxCNNConfig
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro.core.master_slave import make_distributed_conv as jax_make_distributed_conv
from repro.data.pipeline import synthetic_cifar_batches as jax_synthetic_cifar_batches
from repro.layers.conv import max_pool as jax_max_pool
from repro.layers.linear import apply_dense as jax_apply_dense
from repro.layers.norm import local_response_norm as jax_lrn
from repro.models import cnn as jax_cnn
from repro_torch import convert
from repro_torch.configs.base import CNNConfig
from repro_torch.configs.cifar_cnn import CONFIGS
from repro_torch.core.cluster.cluster import HeteroCluster, make_distributed_conv
from repro_torch.data.pipeline import synthetic_cifar_batches
from repro_torch.launch.hetero import run_hetero, sgd_step, train_inputs
from repro_torch.layers.conv import max_pool
from repro_torch.layers.linear import apply_dense
from repro_torch.layers.norm import local_response_norm
from repro_torch.models import cnn

ROOT = os.path.join(os.path.dirname(__file__), "..")
C1, C2, IMAGE, BATCH, LR = 4, 8, 8, 5, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(arch_id=f"cifar_cnn_{C1}_{C2}", c1_kernels=C1, c2_kernels=C2,
              image_size=IMAGE)
    return JaxCNNConfig(**kw), CNNConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    """The JAX params (numpy leaves), a batch, and the JAX single-device
    SGD step from them: (params, images, labels, loss, new_params)."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray, jax_cnn.init_cnn(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = np.arange(BATCH, dtype=np.int32) % 10
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_cnn.cnn_loss(p, jnp.asarray(images), jnp.asarray(labels), cfg=jcfg),
        has_aux=True,
    )(params)
    new = jax.tree.map(lambda p, g: np.asarray(p - LR * g), params, grads)
    return params, images, labels, float(loss), new


def _assert_params_close(got, want, atol=1e-4):
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(np.asarray(got[layer][name]), want[layer][name],
                                       atol=atol, rtol=0, err_msg=f"{layer}/{name}")


def _layer_cases(params, images, labels):
    """name -> (port output, JAX output) on the carried params."""
    jcfg, cfg = _cfgs()
    tp = convert.params_from_numpy(params, "cpu")
    x = np.random.default_rng(2).standard_normal((3, 8, 8, 12)).astype(np.float32) * 3
    tx, ti, tl = torch.from_numpy(x), torch.from_numpy(images), torch.from_numpy(labels)
    ji, jl = jnp.asarray(images), jnp.asarray(labels)
    feat = np.random.default_rng(3).standard_normal((BATCH, params["fc"]["kernel"].shape[0]))
    feat = feat.astype(np.float32)
    return {
        "local_response_norm": (lambda: local_response_norm(tx),
                                lambda: jax_lrn(jnp.asarray(x))),
        "max_pool": (lambda: max_pool(tx, 2, 2), lambda: jax_max_pool(jnp.asarray(x), 2, 2)),
        "apply_dense": (lambda: apply_dense(tp["fc"], torch.from_numpy(feat)),
                        lambda: jax_apply_dense(params["fc"], jnp.asarray(feat))),
        "cnn_forward": (lambda: cnn.cnn_forward(tp, ti, cfg=cfg),
                        lambda: jax_cnn.cnn_forward(params, ji, cfg=jcfg)),
        "cnn_loss": (lambda: torch.stack(cnn.cnn_loss(tp, ti, tl, cfg=cfg)),
                     lambda: jnp.stack(jax_cnn.cnn_loss(params, ji, jl, cfg=jcfg))),
        "cnn_loss_cuda_conv_fn": (
            lambda: torch.stack(cnn.cnn_loss(tp, ti, tl, cfg=cfg,
                                             conv_fn=cnn.conv_fn_for_backend("cuda"))),
            lambda: jnp.stack(jax_cnn.cnn_loss(params, ji, jl, cfg=jcfg))),
    }


@pytest.mark.parametrize("name", ["local_response_norm", "max_pool", "apply_dense",
                                  "cnn_forward", "cnn_loss", "cnn_loss_cuda_conv_fn"])
def test_layer_matches_jax(setup, name):
    params, images, labels, _, _ = setup
    port_fn, jax_fn = _layer_cases(params, images, labels)[name]
    got, want = port_fn().numpy(), np.asarray(jax_fn())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_synthetic_cifar_batches_are_the_jax_ones():
    ours, theirs = synthetic_cifar_batches(4, seed=7), jax_synthetic_cifar_batches(4, seed=7)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        for key in ("images", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_configs_and_init_match_the_jax_shapes():
    from repro.configs.cifar_cnn import CONFIGS as JAX_CONFIGS

    assert set(CONFIGS) == set(JAX_CONFIGS) == set(cnn.PAPER_SIZES)
    for name, cfg in CONFIGS.items():
        assert vars(cfg) == vars(JAX_CONFIGS[name])
    jcfg, cfg = _cfgs()
    ours = convert.params_to_numpy(cnn.init_cnn(torch.Generator().manual_seed(0), cfg))
    theirs = jax.tree.map(np.asarray, jax_cnn.init_cnn(jax.random.key(0), jcfg))
    for layer in theirs:
        for name in theirs[layer]:
            assert ours[layer][name].shape == theirs[layer][name].shape
            assert ours[layer][name].dtype == theirs[layer][name].dtype
    assert abs(ours["conv2"]["kernel"].std() - 1 / np.sqrt(25 * C1)) < 0.05


def test_params_round_trip_through_convert(setup):
    params = setup[0]
    back = convert.params_to_numpy(convert.params_from_numpy(params, "cpu"))
    for layer in params:
        for name in params[layer]:
            np.testing.assert_array_equal(back[layer][name], params[layer][name])


@pytest.mark.parametrize("partition", ["kernel", "spatial", "batch", "auto"])
def test_cluster_train_step_matches_jax(setup, partition):
    """One pipelined train step over a torch:cpu/numpy cluster against
    the JAX cluster step (same axis, numpy devices) and the JAX
    single-device value_and_grad SGD step."""
    params, images, labels, loss_ref, ref_new = setup
    jcfg, cfg = _cfgs()
    kw = dict(pipeline=True, microbatches=2, partition=partition, bandwidth_mbps=100.0)
    jc = JaxHeteroCluster([1.0, 1.5, 2.0], ["numpy"] * 3, **kw)
    try:
        jc.probe_times = [1.0, 1.5, 2.0]
        jnew, jloss, _ = jax_cnn.make_cluster_train_step(jc, jcfg, lr=LR)(
            params, images, labels)
    finally:
        jc.shutdown()
    c = HeteroCluster([1.0, 1.5, 2.0], ["torch:cpu", "numpy", "torch:cpu"], **kw)
    try:
        c.probe_times = [1.0, 1.5, 2.0]
        step = cnn.make_cluster_train_step(c, cfg, lr=LR, device="cpu")
        new, loss, acc = step(convert.params_from_numpy(params, "cpu"), images, labels)
        assert 0.0 < c.comp_duty <= 1.0
    finally:
        c.shutdown()
    assert 0.0 <= acc <= 1.0
    assert abs(loss - loss_ref) <= 1e-5 and abs(loss - jloss) <= 1e-5
    got = convert.params_to_numpy(new)
    _assert_params_close(got, ref_new)
    _assert_params_close(got, jax.tree.map(np.asarray, jnew))


def test_distributed_conv_step_matches_jax(setup):
    """The --pipeline step: autograd of cnn_loss with the cluster as the
    conv, against the JAX package's callback conv with a numpy master."""
    params, images, labels, loss_ref, ref_new = setup
    jcfg, cfg = _cfgs()
    jc = JaxHeteroCluster([1.0, 1.5], ["numpy", "numpy"], pipeline=True, microbatches=2)
    try:
        jc.probe_times = [1.0, 1.5]
        jconv = jax_make_distributed_conv(jc)
        (jloss, _), grads = jax.value_and_grad(
            lambda p: jax_cnn.cnn_loss(p, jnp.asarray(images), jnp.asarray(labels),
                                       cfg=jcfg, conv_fn=jconv), has_aux=True)(params)
        jnew = jax.tree.map(lambda p, g: np.asarray(p - LR * g), params, grads)
    finally:
        jc.shutdown()
    c = HeteroCluster([1.0, 1.5], ["torch:cpu", "numpy"], pipeline=True, microbatches=2)
    try:
        c.probe_times = [1.0, 1.5]
        conv_fn = make_distributed_conv(c)
        ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
        new, loss, _ = sgd_step(
            convert.params_from_numpy(params, "cpu"),
            lambda q: cnn.cnn_loss(q, ti, tl, cfg=cfg, conv_fn=conv_fn), LR)
    finally:
        c.shutdown()
    assert abs(loss - float(jloss)) <= 1e-5 and abs(loss - loss_ref) <= 1e-5
    got = convert.params_to_numpy(new)
    _assert_params_close(got, jnew)
    _assert_params_close(got, ref_new)


def test_run_hetero_train_pipeline_on_cpu_matches_its_autograd_steps():
    """run_hetero's pipelined steps from train_inputs equal the same
    number of single-device autograd SGD steps on those inputs."""
    rec, history = run_hetero([1.0, 1.5], ["torch:cpu", "numpy"], device="cpu",
                             train_pipeline=True, c1=C1, c2=C2, batch=4, steps=2,
                             microbatches=2)
    assert rec["protocol"] == "trainstep-pipelined" and len(rec["losses"]) == 2
    cfg = cnn.make_cnn_config(C1, C2)
    p, images, labels = train_inputs(cfg, 4, "cpu")
    for got_loss, got in zip(rec["losses"], history):
        p, loss, _ = sgd_step(p, lambda q: cnn.cnn_loss(q, images, labels, cfg=cfg), LR)
        assert abs(loss - got_loss) <= 1e-5
        _assert_params_close(convert.params_to_numpy(got), convert.params_to_numpy(p))


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hetero", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("mode", ["--train-pipeline", "--pipeline"])
def test_cli_trains_on_cpu(mode):
    r = _cli(mode, "--device", "cpu", "--c1", "4", "--c2", "8", "--batch", "4",
             "--steps", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    losses = re.search(r"losses=\[([^\]]*)\]", r.stdout).group(1).split(",")
    assert len(losses) == 2 and np.isfinite([float(v) for v in losses]).all()


def test_cli_train_on_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = _cli("--train-pipeline", "--c1", "4", "--c2", "8", "--batch", "4", "--steps", "1")
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert "steps in" not in r.stdout
