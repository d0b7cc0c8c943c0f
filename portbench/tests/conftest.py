"""The harness's CPU tests import ``portbench`` from the repository's
root and the program from ``src``; ``tiny`` gives a cell of
BENCHMARK.json cut to a width the CPU runs in seconds."""
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CPU = {"cuda": "torch:cpu"}  # the program's cuda devices as plain PyTorch ones


ALL_CELLS = sorted(os.path.splitext(f)[0] for f in
                   os.listdir(os.path.join(ROOT, "portbench", "workloads"))
                   if f.endswith(".json"))


def cell_spec(name: str):
    """The spec of any cell file, listed in BENCHMARK.json or not (the
    serving cells wait there for a steadier server, PERF.md)."""
    import json

    from portbench import spec

    bench = spec.load_benchmark()
    if any(w["name"] == name for w in bench["workloads"]):
        return spec.load(name, bench=bench)
    cell = json.load(open(os.path.join(spec.HERE, "workloads", f"{name}.json")))
    cfg = json.load(open(os.path.join(spec.HERE, "configs", f"{cell['config']}.json")))
    entry = {"name": name, "config": cell["config"], "traffic": cell["traffic"],
             "chips": 1, "why": cell["why"]}
    return spec.Spec(name, entry, cell, cfg, bench)


def tiny_spec(name: str, **cell):
    """``name``'s spec at C1 4, C2 8 (batch 4 in 2 microbatches; 40
    requests a second), limits and all else as committed."""
    s = cell_spec(name)
    s.cfg = dict(s.cfg, c1_kernels=4, c2_kernels=8)
    over = ({"batch": 4, "microbatches": 2} if s.mode == "train" else {"rate_per_s": 40.0})
    s.cell = dict(s.cell, **over, **cell)
    return s


@pytest.fixture
def tiny():
    return tiny_spec
