"""Smoke tests of the port's examples (examples/*_torch.py), each run as
a user would, in a subprocess from the repo root with ``src`` on the
import path."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


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
