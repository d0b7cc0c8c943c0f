"""Find a serving cell's knee on the card: the highest offered rate at
which the backlog does not grow over a window.

    python3 -m portbench.sweep --workload <cell> --rates 50,100,200 --seconds 10 --seed <n>

One set-up, then one window at each rate in turn (the cell's traffic at
that rate: ``open_loop_schedule`` over ``--seconds``).  A line a rate:
the rate answered, p50 and p95 from the due time, and the backlog's
growth, the median latency of the window's last fifth over that of its
second fifth.  The cell's file records the knee found so and its rate,
0.8 of it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from portbench import readers, traffic
from portbench import spec as spec_mod
from portbench.run import CACHE_DIRS, ROOT
from portbench.spans import no_range


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT / "src"))
    spec = spec_mod.load(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    cell = dict(spec.cell, rate_per_s=max(rates))
    d = spec.driver().Driver(cell, spec.cfg, args.seed, args.seconds, "cuda")
    pool = d.images
    try:
        for rate in rates:
            d.due = traffic.open_loop_schedule(rate, args.seconds, args.seed)
            d.images = pool[: len(d.due)]
            w = d.window(no_range)
            lat = w["latency_s"]
            fifth = len(lat) // 5
            growth = (float(np.median(lat[-fifth:]) / np.median(lat[fifth:2 * fifth]))
                      if fifth else None)
            print(json.dumps({
                "rate_per_s": rate, "requests": w["requests"], "failed": w["failed"],
                "answered_per_s": w["answered_ok"] / w["seconds"],
                "p50_ms": 1e3 * readers.nearest_rank(lat, 0.5),
                "p95_ms": 1e3 * readers.nearest_rank(lat, 0.95),
                "queue_wait_p95_ms": 1e3 * (readers.nearest_rank(w["queued_s"], 0.95) or 0),
                "backlog_growth": growth,
                "cpu_kernel_share": w["cpu_kernel_share"],
            }), flush=True)
    finally:
        d.close()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
