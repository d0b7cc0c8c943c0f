"""BENCHMARK.json against the benchmark's contract, and every name in it
found: each cell's file, configuration, driver and metric readers."""
import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/") and os.path.isfile(
            os.path.join(spec.ROOT, c["file"]))
        assert c["reduced"] == []
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for cell in m["workloads"]:
            reported = {e["name"] for e in spec.load(cell).metrics(trace=False)}
            assert m["moves"] in reported, (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_step_share_of_peak_beside_every_roofline():
    for m in BENCH["per_layer"]:
        if m["name"].endswith(("roofline.train", "roofline.serve")):
            mfu = [o for o in BENCH["per_layer"] if "mfu" in o["name"]
                   and o["moves"] == m["moves"] and set(m["workloads"]) <= set(o["workloads"])]
            assert mfu, m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    s = spec.load(cell)
    assert hasattr(s.driver(), "Driver")
    e2e = s.metrics(trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert s.metrics(trace=True)
    for m in e2e + s.metrics(trace=True):
        assert callable(spec.reader(m["name"]).read)
    assert s.cfg["arch_id"] == s.entry["config"]
    assert set(s.cell["limits"]) and s.cell["why"] == s.entry["why"]


def test_every_config_has_a_cell_and_a_reference():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert os.path.isfile(os.path.join(spec.HERE, "reference", cfg["reference"] + ".py"))


def test_a_check_fits_the_driver_budget():
    # 24 cells, 2 + 14 runs each, each run_seconds + 60 s, 180 s each to
    # compile, 1200 s spare, within 43200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_a_missing_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load("no_such_cell")
