"""The port's LM training step against the JAX package on the MoE, VLM
and encoder-decoder families, and the training launcher
(``launch/train.py``).

``make_train_step`` is held against the JAX ``make_train_step`` (remat
``none``, no mesh) on reduced moonshot-v1-16b-a3b (moe),
llava-next-mistral-7b (vlm) and whisper-medium (encdec) with sgd, adam
and adafactor, step by step (tests/_torch_train_parity.py states how
and at which tolerances; the dense, ssm and hybrid families are in
tests/test_torch_lm_train.py).  The launcher trains reduced hymba on
the CPU and writes a checkpoint that the JAX package restores.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_train_parity import check_step_parity

from repro.checkpoint.io import restore_checkpoint as jax_restore
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.models.registry import build_model as jax_build_model
from repro_torch.launch.train import train
from repro_torch.train.step import TrainState

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adafactor"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "llava-next-mistral-7b",
                                  "whisper-medium"])
def test_train_step_matches_jax(arch, opt):
    check_step_parity(arch, opt)


def test_launcher_trains_reduced_hymba_on_the_cpu_and_saves_a_jax_checkpoint(tmp_path):
    """``launch/train.py`` for 2 steps of reduced hymba on the CPU: rc 0,
    its log lines, and a checkpoint that the JAX package's
    ``restore_checkpoint`` reads back as its ``init_lm`` tree."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "hymba-1.5b",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step     0 loss=" in r.stdout and "step     1 loss=" in r.stdout
    assert "saved params to" in r.stdout
    got = jax_restore(str(tmp_path))
    want = jax_build_model(jax_reduced(jax_get_config("hymba-1.5b"))).init(
        jax.random.key(0))
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_launcher_refuses_without_a_card():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "hymba-1.5b",
         "--steps", "1"], capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr


def test_train_function_records_every_step():
    state, records = train("mamba2-370m", steps=3, batch=2, seq=8, device="cpu",
                           optimizer="sgd", lr=0.1, log=lambda line: None)
    assert isinstance(state, TrainState) and state.step == 3
    assert [sorted(r) for r in records] == [
        ["aux_loss", "elapsed_s", "grad_norm", "loss", "lr"]] * 3
    assert all(np.isfinite(r["loss"]) for r in records)
