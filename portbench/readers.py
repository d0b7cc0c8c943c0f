"""Arithmetic the metric readers share."""
from __future__ import annotations

import numpy as np

from portbench import work


def nearest_rank(values, q: float) -> float | None:
    """The q-quantile by nearest rank; None where there are no values."""
    s = np.sort(np.asarray(values, np.float64))
    if not len(s):
        return None
    return float(s[max(0, int(np.ceil(q * len(s))) - 1)])


def roofline_pct(run, kind: str) -> float | None:
    """Every traced ``CudaBackend`` call of ``kind`` (``conv`` or
    ``conv_vjp``): the sum of each call's bound (its argument shapes'
    work) over the device time of the kernels launched inside the
    calls' ranges, in %.  None where no such call ran."""
    calls = [c for c in run.calls if c[0] == kind]
    if not calls or run.trace is None:
        return None
    t = run.trace["kernel_s"].get(f"pb.cuda.{kind}", 0.0)
    if t <= 0.0:
        raise RuntimeError(f"{len(calls)} {kind} calls with work, and no kernel "
                           f"time inside their ranges in the trace")
    return 100.0 * sum(work.call_bound_s(kind, x, w) for _, x, w in calls) / t


def idle_pct(run) -> float | None:
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def per_unit_ms(run, seconds: float, unit: str) -> float | None:
    """``seconds`` of the window in ms per training step or per answered
    request."""
    n = run.window.get(unit)
    return 1e3 * seconds / n if n else None
