"""``calibrate.py`` for the residual network cells (mode
``train_resnet``): the same readings, with the faults a training cell
on one device can have (half the batch, a state left unchanged) and the
residual network's own (the shortcuts' gradient dropped) beside the
TF32 control:

    python3 -m portbench.calibrate_resnet --workload resnet50_train_gpu \
        --seeds 20 --first-seed <n> --seconds 0 [--faults 3]

``--witness`` reads instead, seed by seed, the program and the
reference in plain IEEE float32 (TF32 off: the precision the program
states, without its kernels) against the float64 reference, and the
TF32 control beside them; each number's and each leaf's gradient gap,
then a summary line of their quartiles over the seeds:

    python3 -m portbench.calibrate_resnet --witness --workload resnet50_train_gpu \
        --seeds 12 --first-seed <n>
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from portbench import calibrate

FAULTS = ("half_batch", "unchanged", "drop_shortcut")
WITNESSES = ("program", "fp32", "tf32")


def _readings(numbers: dict) -> dict:
    """The numbers, the leaves of the two leaf numbers' largest gaps,
    and the median leaf's gap of norms."""
    more = numbers.pop("detail")
    gaps, errs = more["grad_gap_by_leaf"], more["grad_err_by_leaf"]
    return dict(numbers, grad_gap_leaf_max_at=max(gaps, key=gaps.get),
                grad_err_leaf_max_at=max(errs, key=errs.get),
                grad_gap_leaf_median=statistics.median(gaps.values()))


def witness(argv) -> int:
    from portbench import spec as spec_mod
    from portbench.run import CACHE_DIRS, ROOT

    ap = argparse.ArgumentParser(description="the float32 witness")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT / "src"))
    spec = spec_mod.load(args.workload)
    backend_map = {} if args.device == "cuda" else {"cuda": "torch:cpu"}
    by = {w: {} for w in WITNESSES}
    for i in range(args.seeds):
        seed = args.first_seed + i
        d = spec.driver().Driver(spec.cell, spec.cfg, seed, 0.0, args.device, backend_map)
        d.close()
        d.detail = True
        line = {"seed": seed, "program": _readings(d.check())}
        for kind in WITNESSES[1:]:
            line[kind] = _readings(d.control(kind))
        for w in WITNESSES:
            for k, v in line[w].items():
                if not isinstance(v, str):
                    by[w].setdefault(k, []).append(v)
        print(json.dumps(line), flush=True)
    summary = {w: {k: _quartiles(vs) for k, vs in d.items()} for w, d in by.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


def _quartiles(vs) -> list:
    """Smallest, quartiles and largest."""
    if len(vs) < 2:
        return [min(vs), *vs, max(vs)]
    return [min(vs), *statistics.quantiles(vs, n=4), max(vs)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--witness" in argv:
        argv.remove("--witness")
        return witness(argv)
    calibrate.FAULTS = dict(calibrate.FAULTS, train_resnet=FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
