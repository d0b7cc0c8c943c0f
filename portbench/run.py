"""Run one cell of BENCHMARK.json once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``)
beside this folder.  Set-up (the driver's constructor: the cluster, its
Eq. 1 probe, the weights from the seed, the warm-up) counts as
``setup_s``; then the window runs for ``--seconds``; then the program is
freed and the timed path's output is compared with the plain reference.
With ``--trace 1`` the window runs under ``torch.profiler`` with the
ranges of ``spans.py`` and the line carries the per-layer metrics,
``device.busy_s`` / ``window_s`` and ``breakdown``; with ``--trace 0``
the end-to-end metrics.

Standard output ends with a line ``{"record": ...}`` (Eq. 1's probe
times, shares and kernels per device, the host's CPUs, the card's
clocks and power limit, the window's counts) and then the result's line;
standard error ends with each compared number beside its limit.  No
card, fewer cards than the cell asks for, the program missing, or a JAX
module (or the JAX package, ``repro``) loaded once the window has closed:
a message, no result, and a nonzero exit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import devtrace, spec as spec_mod  # noqa: E402
from portbench.spans import Spans, no_range  # noqa: E402

ROOT = spec_mod.ROOT
# top-level module names no process of a run may hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE_DIRS = {  # fixed paths inside the checkout: only a first run builds
    "TORCH_EXTENSIONS_DIR": "build/portbench_cache/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench_cache/triton",
    "CUDA_CACHE_PATH": "build/portbench_cache/cuda",
}


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    name: str
    cell: dict
    cfg: dict
    setup_s: float
    window: dict
    trace: dict | None = None
    calls: list = dataclasses.field(default_factory=list)


def forbidden_modules(names=None) -> list:
    """The top-level names of ``names`` (default: ``sys.modules``) that
    are in FORBIDDEN, each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.partition(".")[0] for m in names} & set(FORBIDDEN))


def card_state() -> dict | None:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return {"query": query, "rows": out.stdout.strip().splitlines()}


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(spec, seed: int, seconds: float, trace: bool, device: str = "cuda",
             backend_map: dict | None = None, t_start: float = T_START):
    """One run of ``spec``'s cell; returns (result, record).  ``device``
    and ``backend_map`` let the CPU tests drive it at a tiny size
    (``{"cuda": "torch:cpu"}``); the command line always runs the card."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    driver = spec.driver().Driver(spec.cell, spec.cfg, seed, seconds, device, backend_map)
    setup_s = time.perf_counter() - t_start
    summary, spans = None, Spans()
    try:
        if trace:
            chain = getattr(getattr(driver, "server", None), "_chain", None)
            spans.install(driver.cluster, chain)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            try:
                # the cluster's and the server's threads start in set-up,
                # before the profiler: their ranges need every thread
                with profile(activities=acts,
                             experimental_config=_ExperimentalConfig(
                                 profile_all_threads=True)) as prof:
                    with record_function("pb.window"):
                        window = driver.window(Spans.range)
            finally:
                spans.uninstall()
            summary = devtrace.summarize(prof)
            del prof
        else:
            window = driver.window(no_range)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        driver.close()
    numbers = driver.check()
    limits = spec.cell["limits"]
    checks = {k: {"value": _finite(v), "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    run = Run(spec.name, spec.cell, spec.cfg, setup_s, window, summary, spans.calls)
    metrics = {}
    for m in spec.metrics(trace):
        value = spec_mod.reader(m["name"]).read(run)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} has nothing to read")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name() if on_card else device,
           "count": spec.entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(window["attempted"]),
              "failed": int(window["failed"]), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    record = {
        "workload": spec.name, "seed": seed, "seconds": seconds, "trace": int(trace),
        "eq1_setup": driver.eq1, "eq1_window_end": window.get("eq1_after"),
        "host_cpus": os.cpu_count(),
        "window": {k: v for k, v in window.items()
                   if k in ("steps", "images", "seconds", "requests", "answered_ok",
                            "statuses", "timing", "attempted", "failed")},
        "lateness_ms_max": (1e3 * float(max(window["lateness_s"]))
                            if len(window.get("lateness_s", [])) else None),
    }
    if summary is not None:
        record["trace"] = {k: summary[k] for k in ("attributed", "unattributed_ops",
                                                  "kernel_s", "copy_s", "device_events")}
        record["cuda_calls"] = {k: sum(c[0] == k for c in spans.calls)
                                for k in ("conv", "conv_vjp")}
    return result, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = spec_mod.load(args.workload)
    except (OSError, KeyError, ValueError, StopIteration) as e:
        print(f"portbench: cannot load workload {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return 2
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    chips = spec.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, record = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found} (none of {FORBIDDEN} may be loaded)",
              file=sys.stderr)
        return 4
    record["card"] = card_state()
    print(json.dumps({"record": record}))
    print(json.dumps(result))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} <= {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # a process holding CUDA runtime threads skips finalization
