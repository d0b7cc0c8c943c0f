"""A run end to end on the CPU at a tiny width (the program's cuda
devices as plain PyTorch ones): the last line's keys and metrics, and
the command line's refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec
from conftest import ALL_CELLS, CPU, ROOT, tiny_spec

SEED = 2 ** 31 + 4099
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
# read from the card's trace: a CPU run has no kernel time to read
DEVICE_ONLY = ("roofline", "copy_ms", "device_idle")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_last_line(cell, trace):
    s = tiny_spec(cell)
    result, record = run.run_cell(s, SEED, 1.0, bool(trace), device="cpu", backend_map=CPU)
    line = json.loads(json.dumps(result, allow_nan=False))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    want = {m["name"] for m in s.metrics(bool(trace))
            if not any(k in m["name"] for k in DEVICE_ONLY)}
    assert want <= set(line["metrics"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(line["checks"]) == set(s.cell["limits"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert record["eq1_setup"]["probe_s"] and record["host_cpus"]


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed",
         str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_refuses_without_a_card():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr
