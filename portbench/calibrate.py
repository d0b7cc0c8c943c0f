"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --first-seed <n>
        [--seconds 3] [--faults 3]

For each of ``--seeds`` seeds: the cell's set-up, a window of
``--seconds`` (a serving cell's answers; a training cell's readings
come from set-up's checked steps, so 0 will do), and the program's
numbers against the plain reference: the lower readings.  For the
first ``--faults`` seeds also the control (the reference in TF32 in the
program's place) and each fault the cell can have, planted in the
reference put in the program's place: the upper readings.  One JSON
line a seed (``--detail``: a training cell's gaps by step and by leaf
too), then a line with each number's largest program reading, smallest
control and fault readings, and the limit those suggest (two thirds of
the way up from the lower reading to the upper one, in logarithms),
from which the cell's file takes its limit.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from portbench import spec as spec_mod
from portbench.run import CACHE_DIRS, ROOT
from portbench.spans import no_range

FAULTS = {"train": ("half_batch", "no_exchange", "unchanged"),
          "serve": ("no_exchange", "swapped")}
# a fault counts against a training number only where it reads this many
# times the number's lower reading (a state left unchanged: 3, the control 3)
FAULT_FACTOR = {"unchanged": 3.0, "tf32": 3.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--detail", action="store_true",
                    help="a training cell's gaps by step and by leaf too")
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT / "src"))
    spec = spec_mod.load(args.workload)
    kinds = ("tf32",) + tuple(k for k in FAULTS[spec.mode]
                              if k != "no_exchange" or len(spec.cell["backends"]) > 1)
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        d = spec.driver().Driver(spec.cell, spec.cfg, seed, args.seconds, "cuda")
        d.detail = args.detail
        try:
            if args.seconds > 0:
                d.window(no_range)
        finally:
            d.close()
        line = {"seed": seed, "program": d.check(), "eq1": d.eq1}
        for k, v in line["program"].items():
            if k != "detail":
                lower[k] = max(lower.get(k, 0.0), v)
        if i < args.faults:
            line["controls"] = {k: d.control(k) for k in kinds}
            for kind, numbers in line["controls"].items():
                for k, v in numbers.items():
                    if k == "detail":
                        continue
                    upper.setdefault(k, {}).setdefault(kind, []).append(v)
        print(json.dumps(line), flush=True)
    summary = {}
    for k, lo in lower.items():
        readings = {kind: min(vs) for kind, vs in upper.get(k, {}).items()}
        held = {kind: v for kind, v in readings.items()
                if v >= FAULT_FACTOR.get(kind, 10.0) * max(lo, 1e-30)}
        up = min(held.values()) if held else None
        limit = (math.exp(math.log(max(lo, 1e-30)) / 3 + 2 * math.log(up) / 3)
                 if up else None)
        summary[k] = {"lower": lo, "upper": up, "upper_by": readings, "suggested_limit": limit}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
