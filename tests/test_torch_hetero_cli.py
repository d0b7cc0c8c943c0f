"""Twin of tests/test_hetero_cli.py over the port's command line,
``python -m repro_torch.launch.hetero --device cpu``: it must EXIT in
every configuration.

The JAX package's CLI once hung at interpreter exit with an ``xla``
slave; the port's twin of that case runs a ``torch:cpu`` slave, whose
intra-op threads outlive the steps in the same way.  A subprocess run
with a timeout is the regression test: if a hang comes, the timeout
fires.  The fast case also runs the JAX package's CLI on the same flags
and holds the port's record to carry every field of the reference's.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run_hetero(tmp_path, *args, module="repro_torch.launch.hetero", timeout=600):
    out = tmp_path / f"{module}.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    device = ["--device", "cpu"] if module.startswith("repro_torch.") else []
    r = subprocess.run(
        [sys.executable, "-m", module,
         "--steps", "1", "--batch", "2", "--c1", "4", "--c2", "4",
         "--out", str(out), *device, *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(out.read_text().splitlines()[0])
    assert len(rec["losses"]) == 1
    return rec, r.stdout


@pytest.mark.slow
def test_cli_exits_cleanly_with_torch_slave(tmp_path):
    """The reference's hang configuration with the port's backend in
    place of the ``xla`` slave: training driven through the cluster
    with a ``torch:cpu`` SLAVE.  Completing within the timeout IS the
    test."""
    rec, stdout = _run_hetero(
        tmp_path, "--slowdowns", "1.0,1.0", "--backends", "numpy,torch:cpu",
    )
    assert rec["backends"] == ["numpy", "torch:cpu"]
    assert "steps in" in stdout


@pytest.mark.slow
def test_cli_exits_cleanly_with_tcp_transport(tmp_path):
    """The full-lane e2e shape: one real train step over subprocess TCP
    slaves (``torch:cpu`` processes), train-pipeline schedule."""
    rec, _ = _run_hetero(
        tmp_path, "--slowdowns", "1.0,1.5", "--transport", "tcp",
        "--train-pipeline",
    )
    assert rec["transport"] == "tcp"
    assert all(b and b > 0 for b in rec["measured_bandwidth_mbps"])


def test_cli_exits_cleanly_all_numpy_fast(tmp_path):
    """Fast-lane guard on the exit path itself (numpy slave, tiny); the
    record has every field of the JAX package's CLI on the same flags."""
    flags = ("--slowdowns", "1.0,1.0", "--backends", "numpy,numpy", "--train-pipeline")
    rec, _ = _run_hetero(tmp_path, *flags, timeout=300)
    assert rec["protocol"] == "trainstep-pipelined"
    ref, _ = _run_hetero(tmp_path, *flags, module="repro.launch.hetero", timeout=300)
    assert ref["protocol"] == rec["protocol"]
    assert set(ref) <= set(rec), sorted(set(ref) - set(rec))
