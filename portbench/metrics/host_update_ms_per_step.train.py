"""host_update_ms_per_step.train: the program's spans around SGD on the
conv kernels (``step.kernels_to_host``, the kernels to numpy;
``step.update_host``, numpy's update; ``step.kernels_to_card``, the new
kernels back) in the traced window, per step.  None for a program
without its own spans."""
NAMES = ("step.kernels_to_host", "step.update_host", "step.kernels_to_card")


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
