"""Finds what ``BENCHMARK.json`` names: a cell's file
(``workloads/<cell>.json``), its configuration (the file the
configuration's entry names), its driver (``drivers/<mode>.py``) and
the reader of each of its metrics (``metrics/<metric>.py``)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Spec:
    name: str
    entry: dict   # the cell's entry in BENCHMARK.json
    cell: dict    # workloads/<cell>.json
    cfg: dict     # the configuration's file
    bench: dict

    @property
    def mode(self) -> str:
        return self.cell["mode"]

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.mode}")

    def metrics(self, trace: bool) -> list:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (``trace`` true), as BENCHMARK.json gives them."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def load(name: str, root: Path = ROOT, bench: dict | None = None) -> Spec:
    """The cell ``name``; raises KeyError or FileNotFoundError where
    BENCHMARK.json or a file it names is missing, ValueError where the
    cell's file disagrees with its entry."""
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {cell[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    cfg = json.loads((root / conf["file"]).read_text())
    return Spec(name, entry, cell, cfg, bench)


def reader(metric: str):
    """The module of ``metrics/<metric>.py``, whose ``read(run)``
    returns the metric's value, or None where the run has nothing to
    read for it."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{metric.replace('.', '_')}", path)
    if mod_spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
