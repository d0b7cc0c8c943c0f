"""head_ms_per_step.train: the program's ``step.head`` spans (each
microbatch's dense head, loss and gradients on the master, up to the
card's drain; its copies are ``stage_copy_ms_per_step.train``'s) in the
traced window, per step.  None for a program without the span."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    head = spans.counters().get("step.head")
    steps = run.window.get("steps")
    if not steps or head is None:
        return None
    return 1e3 * head.s / steps
