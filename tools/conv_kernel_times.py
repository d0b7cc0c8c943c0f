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
``torch.profiler`` trace, divided by ``reps``; ``library_ms`` and
``library_device_ms``, the same two times of the one PyTorch call that
computes the same function (``F.conv2d``, ``conv2d_input``,
``conv2d_weight`` on NCHW copies, TF32 off: a yardstick the port never
calls); the wrapper's launches
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
# serving (4 images) and training (8) paths, and both layers at batch 32;
# K2's training shards span the Cout that Eq. 1's shares gave them
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
    ("conv2d_dx", "C1 train shard", (8, 32, 32, 3, 106, 5)),
    ("conv2d_dx", "C1 train shard", (8, 32, 32, 3, 159, 5)),
    ("conv2d_dx", "C2 train shard", (8, 16, 16, 500, 297, 5)),
    ("conv2d_dx", "C2 train shard", (8, 16, 16, 500, 363, 5)),
    ("conv2d_dx", "C2 train shard", (8, 16, 16, 500, 459, 5)),
    ("conv2d_dx", "C2 train shard", (8, 16, 16, 500, 487, 5)),
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


def library_call(kind, x, w, g):
    """The one PyTorch call that computes the kernel's function, on
    NCHW/OIHW copies made outside the timed call."""
    import torch.nn.functional as F

    pad = w.shape[0] // 2
    xc = x.permute(0, 3, 1, 2).contiguous()
    gc = g.permute(0, 3, 1, 2).contiguous()
    wc = w.permute(3, 2, 0, 1).contiguous()
    if kind == "conv2d_fwd":
        return lambda: F.conv2d(xc, wc, padding=pad)
    if kind == "conv2d_dx":
        return lambda: torch.nn.grad.conv2d_input(xc.shape, wc, gc, padding=pad)
    return lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, gc, padding=pad)


def timed(fn, reps: int):
    """(median over 3 rounds of the CUDA-event ms per call, the SM clock
    readings taken meanwhile, the profiler's device ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per, mhz, stop = [], [], threading.Event()
    watcher = threading.Thread(target=sample_sm_clock, args=(stop, mhz))
    watcher.start()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    stop.set()
    watcher.join()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return statistics.median(per), mhz[:-1], dev_us / 1e3 / reps


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

    if not Path(conv.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {conv.__file__}, not {src}")
    print(json.dumps({"label": args.label, "src": str(src),
                      "nvidia_smi": smi("name,power.limit", "csv,noheader"),
                      "max_sm_clock_mhz": int(smi("clocks.max.sm"))}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
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
        before = wrapper.launches
        ms, mhz, dev_ms = timed(lambda: fn(x, wt, g), args.reps)
        launches = (wrapper.launches - before) / (args.reps * 4 + 1)
        lib_ms, _, lib_dev_ms = timed(library_call(kind, x, wt, g), args.reps)
        print(json.dumps({
            "label": args.label, "kernel": kind, "case": label,
            "shape": {"x": [b, h, w, cin], "w": [k, k, cin, cout]},
            "ms": ms, "device_ms": dev_ms,
            "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "launches_per_call": launches,
            "sm_clock_mhz": statistics.median(mhz) if mhz else None,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
