"""stage_copy_ms_per_step.train: the program's spans ``step.to_card`` and
``step.to_host`` (each activation and gradient of the master stages and
the loss head between the cluster's numpy and the card, host time) in
the traced window, per step.  None for a program without its own
spans."""
NAMES = ("step.to_card", "step.to_host")


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    c = spans.counters()
    steps = run.window.get("steps")
    if not steps or not any(n in c for n in NAMES):
        return None
    return 1e3 * sum(c[n].s for n in NAMES if n in c) / steps
