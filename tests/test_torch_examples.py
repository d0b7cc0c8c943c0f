"""Tests of the port's examples (examples/*_torch.py).

Smoke runs, each as a user would, in a subprocess from the repo root
with ``src`` on the import path; and each twin of a JAX example held
against its reference (examples/<name>.py, imported by path, unchanged)
on the same inputs: quickstart's local and distributed losses,
hetero_cluster's Eq. 1 split, serve_batched's cache bytes per sequence
and train_lm's checkpoint, read back by the JAX package.  Every twin
refuses to run without a card unless given ``--device cpu``.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import restore_checkpoint as jax_restore_checkpoint
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro.core.partitioner import workload_shares as jax_workload_shares
from repro.data.pipeline import synthetic_token_batches as jax_token_batches
from repro.layers.conv import apply_conv as jax_apply_conv
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.models.cnn import make_cnn_config as jax_make_cnn_config
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import rules_for_mode as jax_rules_for_mode
from repro.train.loss import softmax_cross_entropy as jax_softmax_cross_entropy
from repro_torch.convert import params_from_numpy
from repro_torch.core.master_slave import HeteroCluster, make_distributed_conv
from repro_torch.models.cnn import conv_fn_for_backend, make_cnn_config
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
TWINS = ("quickstart_torch", "hetero_cluster_torch", "serve_batched_torch",
         "train_lm_torch")


def _run(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _example(name: str):
    """examples/<name>.py as a module (imported by path, not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_model_config(cfg) -> JaxModelConfig:
    """The JAX package's ModelConfig with the port config's fields."""
    fields = dataclasses.asdict(cfg)
    if cfg.ssm is not None:
        fields["ssm"] = JaxSSMConfig(**fields["ssm"])
    return JaxModelConfig(**fields)


def test_serve_cluster_torch_on_the_cpu():
    """The burst under a default deadline, then the one-at-a-time
    baseline: rc 0, the req/s line and the baseline line."""
    r = _run("examples/serve_cluster_torch.py", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.search(r"dynamic batching \(max_batch=4\) on cpu: 16 requests in "
                     r"[\d.]+s -> \d+ req/s  p50=[\d.]+ms p99=[\d.]+ms", r.stdout), r.stdout
    assert re.search(r"one-at-a-time baseline: [\d.]+s \([\d.]+x slower\)", r.stdout), r.stdout


def test_serve_cluster_torch_needs_a_card_by_default():
    """``--device cuda`` is the default and never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    r = _run("examples/serve_cluster_torch.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


@pytest.mark.parametrize("name", TWINS)
def test_twin_needs_a_card_by_default(name):
    """Each twin's ``--device`` defaults to ``cuda`` and refuses to run
    without a card, before any training or serving starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    r = _run(f"examples/{name}.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "step" not in r.stdout and "==" not in r.stdout, r.stdout


# -- quickstart --------------------------------------------------------------


@pytest.mark.parametrize("local", ["torch", "cuda"])
def test_quickstart_losses_equal_jax(local):
    """5 steps at c1 4 and c2 8 from the JAX package's ``init_cnn(key(0))``
    carried into the port: the port's local losses (the plain conv, or
    ``Conv2dFunction``'s plain path on CPU tensors) equal the JAX
    ``train()``'s within rtol 1e-4, and its distributed losses over
    ``HeteroCluster([1.0, 1.0, 2.0])`` equal its local ones as closely."""
    ref, qs = _example("quickstart"), _example("quickstart_torch")
    steps = 5
    jax_losses, _ = ref.train(jax_make_cnn_config(4, 8), jax_apply_conv, steps)
    start = jax.tree.map(np.asarray, jax_init_cnn(jax.random.key(0),
                                                  jax_make_cnn_config(4, 8)))
    cfg = make_cnn_config(4, 8)
    local_losses, _ = qs.train(cfg, conv_fn_for_backend(local), steps, device="cpu",
                               params=params_from_numpy(start, "cpu"))
    np.testing.assert_allclose(local_losses, jax_losses, rtol=RTOL)
    cluster = HeteroCluster([1.0, 1.0, 2.0], ["torch:cpu"] * 3)
    try:
        cluster.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=4,
                      batch=64)
        dist_losses, _ = qs.train(cfg, make_distributed_conv(cluster), steps,
                                  device="cpu", params=params_from_numpy(start, "cpu"))
    finally:
        cluster.shutdown()
    np.testing.assert_allclose(dist_losses, local_losses, rtol=RTOL)


def test_quickstart_torch_on_the_cpu():
    """The script as a user runs it on the CPU (10 steps, narrow): both
    trainings, the drift line and the OK line, rc 0."""
    r = _run("examples/quickstart_torch.py", "--device", "cpu", "--steps", "10",
             "--c1", "4", "--c2", "8")
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.search(r"Eq.1 shares: \[[\d., ]+\]", r.stdout), r.stdout
    assert re.search(r"max \|loss_local - loss_distributed\| over training = "
                     r"[\d.e+-]+", r.stdout), r.stdout
    assert "OK: loss decreases AND distribution does not affect" in r.stdout


# -- hetero_cluster ----------------------------------------------------------

# probe times pinned per cluster (by its backends): wall-clock probes
# would make the split depend on the host's load
PINNED = {("torch:cpu",) * 3: [0.031, 0.034, 0.102],
          ("numpy", "torch:cpu", "torch:cpu"): [0.009, 0.036, 0.074]}


def test_hetero_cluster_shares_equal_jax(monkeypatch):
    """The twin's whole run on the CPU with every probe's times pinned:
    the Eq. 1 shares and the kernels of 240 per device, of the balanced
    and the mixed cluster, equal the JAX package's ``shares_for(240)``
    under the same times."""
    hc = _example("hetero_cluster_torch")
    real_probe = HeteroCluster.probe

    def pinned_probe(self, **kw):
        real_probe(self, **kw)
        self.probe_times = list(PINNED[tuple(self.backends)])
        return self.probe_times

    monkeypatch.setattr(HeteroCluster, "probe", pinned_probe)
    out = hc.main(["--device", "cpu"])

    def jax_kernels(slowdowns, times):
        c = JaxHeteroCluster(slowdowns)
        try:
            c.probe_times = list(times)
            return c.shares_for(240).tolist()
        finally:
            c.shutdown()

    times = PINNED[("torch:cpu",) * 3]
    np.testing.assert_allclose(out["shares"], jax_workload_shares(times), rtol=1e-12)
    assert out["kernels"] == jax_kernels([1.0, 1.0, 3.0], times)
    assert out["equal_kernels"] == jax_kernels([1.0, 1.0, 3.0], [1.0] * 3) == [80] * 3
    assert out["mixed_kernels"] == jax_kernels(
        [1.0, 1.0, 2.0], PINNED[("numpy", "torch:cpu", "torch:cpu")])
    for key in ("single_ms", "balanced_ms", "equal_ms", "barrier_ms", "pipelined_ms",
                "mixed_ms"):
        assert out[key] > 0


def test_hetero_cluster_torch_on_the_cpu():
    """The script as a user runs it on the CPU: the four sections' lines,
    rc 0."""
    r = _run("examples/hetero_cluster_torch.py", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    for pattern in (r"single-device conv: [\d.]+ ms",
                    r"Eq.1 shares: \[[\d., ]+\] -> kernels \[\d+, \d+, \d+\]",
                    r"Eq.1 vs equal split: [\d.]+x faster",
                    r"pipeline hides comm behind compute: [\d.]+x faster",
                    r"mixed-backend distributed conv: [\d.]+ ms"):
        assert re.search(pattern, r.stdout), (pattern, r.stdout)


# -- serve_batched -----------------------------------------------------------


def _regimes():
    return [name for name, _ in _example("serve_batched_torch").regimes()]


@pytest.mark.parametrize("regime", _regimes())
def test_serve_batched_cache_bytes_equal_jax(regime):
    """Each regime's cache bytes per sequence from the port's
    ``init_cache`` (shapes and dtypes only) equal the reference's
    ``jax.eval_shape`` count, at the demo's batch and context."""
    ref, sb = _example("serve_batched"), _example("serve_batched_torch")
    cfg = dict(sb.regimes())[regime]
    batch, context = 4, 32 + 24
    japi = jax_build_model(_jax_model_config(cfg))
    want = ref.cache_bytes(jax.eval_shape(lambda: japi.init_cache(batch, context))) / batch
    assert sb.cache_bytes_per_seq(build_model(cfg), batch, context) == want


def test_serve_batched_torch_on_the_cpu():
    """The script as a user runs it on the CPU: one line per regime,
    each cache figure the reference's (the sampled tokens are not
    compared: the two packages' generators differ), rc 0."""
    ref, sb = _example("serve_batched"), _example("serve_batched_torch")
    r = _run("examples/serve_batched_torch.py", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    for name, cfg in sb.regimes():
        japi = jax_build_model(_jax_model_config(cfg))
        kib = ref.cache_bytes(jax.eval_shape(lambda: japi.init_cache(4, 56))) / 4 / 2**10
        line = re.escape(f"{name:28s}") + r" +[\d.]+ tok/s  cache/seq= *" + \
            re.escape(f"{kib:.1f}") + r" KiB  sample: \[[\d, ]+\]"
        assert re.search(line, r.stdout), (line, r.stdout)


# -- train_lm ----------------------------------------------------------------


def test_train_lm_learns_and_jax_restores_its_checkpoint(monkeypatch, tmp_path):
    """The twin's run on the CPU with ``LM_100M`` swapped for a 2-layer
    model of 64 tokens: the learned assertion holds, and the JAX
    package's ``restore_checkpoint`` reads the port's checkpoint, whose
    eval loss there, on the batch the twin evaluated it on, equals the
    twin's within rtol 1e-4."""
    tl = _example("train_lm_torch")
    small = tl.LM_100M.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                             d_ff=128, vocab_size=64, head_dim=16)
    monkeypatch.setattr(tl, "LM_100M", small)
    steps, batch, seq = 60, 8, 32
    out = tl.main(["--device", "cpu", "--steps", str(steps), "--batch", str(batch),
                   "--seq", str(seq), "--lr", "3e-3", "--ckpt-dir", str(tmp_path)])
    assert out["restored_eval_loss"] < out["first_loss"] - 1.0

    restored = jax_restore_checkpoint(str(tmp_path))
    japi = jax_build_model(_jax_model_config(small))
    # the twin's eval batches: one a logged step, then the restored eval's
    logged = sum(1 for i in range(steps) if i % 25 == 0 or i == steps - 1)
    it = jax_token_batches(batch, seq, small.vocab_size, seed=0, stream_seed=999)
    for _ in range(logged):
        next(it)
    eb = {k: jnp.asarray(v) for k, v in next(it).items()}
    logits, _ = japi.forward(restored, eb, rules=jax_rules_for_mode("megatron"))
    want = float(jax_softmax_cross_entropy(logits, eb["labels"]))
    np.testing.assert_allclose(out["restored_eval_loss"], want, rtol=RTOL)
