"""norm_ms_per_step.train: the program's ``step.norm`` spans (each batch
norm's forward or backward in a ResNet's stages, up to the card's
drain) in the traced window, per step.  None for a program without the
span."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    norm = spans.counters().get("step.norm")
    steps = run.window.get("steps")
    if not steps or norm is None:
        return None
    return 1e3 * norm.s / steps
