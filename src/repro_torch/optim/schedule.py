"""Learning-rate schedules of the port: constant, cosine, and WSD.

Counterpart of ``repro/optim/schedule.py``: a schedule is a plain
function of an int step that returns the JAX schedule's float32 value,
computed in numpy float32 as ``jnp`` computes it.  WSD
(warmup-stable-decay) is minicpm's schedule (arXiv:2404.06395): linear
warmup, a long stable plateau, then a decay tail over the last 10% of
the steps, linear in log.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

_F32 = np.float32


def make_schedule(
    kind: str,
    *,
    learning_rate: float,
    warmup_steps: int,
    total_steps: int,
    final_fraction: float = 0.1,
    wsd_decay_fraction: float = 0.1,
) -> Callable[[int], np.float32]:
    """Returns step -> lr, a numpy float32."""
    lr = _F32(learning_rate)
    final = _F32(final_fraction)

    def warmup(step):
        return np.minimum(_F32(1.0), _F32(step + 1) / _F32(max(warmup_steps, 1)))

    if kind == "constant":
        def f(step):
            return lr * warmup(step)
        return f

    if kind == "cosine":
        def f(step):
            t = np.clip((_F32(step) - _F32(warmup_steps))
                        / _F32(max(total_steps - warmup_steps, 1)), _F32(0.0), _F32(1.0))
            cos = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * t))
            scale = final + (_F32(1.0) - final) * cos
            return lr * warmup(step) * scale
        return f

    if kind == "wsd":
        decay_steps = max(int(total_steps * wsd_decay_fraction), 1)
        decay_start = total_steps - decay_steps

        def f(step):
            if step < decay_start:
                decay = _F32(1.0)
            else:
                in_decay = (_F32(step) - _F32(decay_start)) / _F32(decay_steps)
                decay = final ** np.clip(in_decay, _F32(0.0), _F32(1.0))
            return lr * warmup(step) * decay
        return f

    raise ValueError(f"unknown schedule {kind!r}")
