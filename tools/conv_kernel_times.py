"""Time the port's conv kernels (K1 forward, K2 dX, K3 dW) at the main
path's shapes, on one CUDA card, for the ``repro_torch`` package found
under ``--src``.

    python tools/conv_kernel_times.py --src src --label change
    python tools/conv_kernel_times.py --src archive/parent/src --label parent

Run it for two trees in one call, in turns (parent, change, change,
parent), to compare them on one card.  Each shape prints one JSON line:
``ms``, the median over 3 rounds of CUDA-event time of ``reps``
back-to-back wrapper calls divided by ``reps`` (the host's work per call
included: a launch-bound shape measures the wrapper); ``device_ms``, the
summed device time of every kernel and memset those calls ran, from a
``torch.profiler`` trace, divided by ``reps``; the wrapper's launches
per call; and ``sm_clock_mhz``, the median of the SM clocks that
``nvidia-smi`` read while the timed rounds ran (null when the rounds
were too short for a reading).  The first line names the card and its
power limit.  Inputs come from numpy's generator, seeded by the
shape.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

# (kernel, label, (B, H, W, Cin, Cout, k)): the C1 and C2 shards of the
# serving (4 images) and training (8) paths, and both layers at batch 32
SHAPES = [
    ("conv2d_fwd", "C1 serve shard", (4, 32, 32, 3, 172, 5)),
    ("conv2d_fwd", "C1 serve, whole layer", (4, 32, 32, 3, 500, 5)),
    ("conv2d_fwd", "C1 train shard", (8, 32, 32, 3, 106, 5)),
    ("conv2d_fwd", "C1 train shard", (8, 32, 32, 3, 159, 5)),
    ("conv2d_fwd", "C1 batch 32", (32, 32, 32, 3, 500, 5)),
    ("conv2d_fwd", "C2 serve shard", (4, 16, 16, 500, 449, 5)),
    ("conv2d_fwd", "C2 train shard", (8, 16, 16, 500, 459, 5)),
    ("conv2d_dw", "C1 train shard", (8, 32, 32, 3, 106, 5)),
    ("conv2d_dw", "C1 train shard", (8, 32, 32, 3, 159, 5)),
    ("conv2d_dw", "C1 batch 32", (32, 32, 32, 3, 500, 5)),
    ("conv2d_dw", "C2 train shard", (8, 16, 16, 500, 459, 5)),
    ("conv2d_dw", "C2 batch 32", (32, 16, 16, 500, 1500, 5)),
    ("conv2d_dx", "C1 batch 32", (32, 32, 32, 3, 500, 5)),
    ("conv2d_dx", "C2 batch 32", (32, 16, 16, 500, 1500, 5)),
]


def smi(query: str, fmt: str = "csv,noheader,nounits") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def sample_sm_clock(stop: threading.Event, mhz: list) -> None:
    """Read the SM clock until ``stop`` is set; each reading takes tens
    of ms, so the loop it watches must outlast one."""
    while not stop.is_set():
        mhz.append(int(smi("clocks.sm")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the directory holding repro_torch/")
    ap.add_argument("--label", required=True, help="names the tree in every line")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch.kernels.conv2d as conv
    from torch.profiler import ProfilerActivity, profile

    if not Path(conv.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {conv.__file__}, not {src}")
    print(json.dumps({"label": args.label, "src": str(src),
                      "nvidia_smi": smi("name,power.limit", "csv,noheader"),
                      "max_sm_clock_mhz": int(smi("clocks.max.sm"))}), flush=True)
    dev = torch.device("cuda", 0)
    calls = {
        "conv2d_fwd": lambda x, w, g: conv.conv2d(x, w),
        "conv2d_dx": lambda x, w, g: conv.conv2d_dx(g, w),
        "conv2d_dw": lambda x, w, g: conv.conv2d_dw(x, g, w.shape[0], w.shape[1]),
    }
    for kind, label, (b, h, w, cin, cout, k) in SHAPES:
        rng = np.random.default_rng([b, h, w, cin, cout, k])
        x, wt, g = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((b, h, w, cin)),
            rng.standard_normal((k, k, cin, cout)) * 0.1,
            rng.standard_normal((b, h, w, cout))))
        fn = calls[kind]
        wrapper = getattr(conv, {"conv2d_fwd": "conv2d"}.get(kind, kind))
        fn(x, wt, g)
        torch.cuda.synchronize()
        per, mhz, stop = [], [], threading.Event()
        watcher = threading.Thread(target=sample_sm_clock, args=(stop, mhz))
        watcher.start()
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn(x, wt, g)
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / args.reps)
        stop.set()
        watcher.join()
        mhz = mhz[:-1]  # the last reading may have begun after the rounds
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn(x, wt, g)
            torch.cuda.synchronize()
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        print(json.dumps({
            "label": args.label, "kernel": kind, "case": label,
            "shape": {"x": [b, h, w, cin], "w": [k, k, cin, cout]},
            "ms": statistics.median(per), "device_ms": dev_us / 1e3 / args.reps,
            "launches_per_call": (wrapper.launches - before) / args.reps,
            "sm_clock_mhz": statistics.median(mhz) if mhz else None,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
