"""shortcut_ms_per_step.train: the program's ``step.shortcut`` spans
(each residual add, each sum of a two-consumer tensor's gradients, each
stride-2 subsample and its transpose in a ResNet's stages, up to the
card's drain) in the traced window, per step.  None for a program
without the span."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    shortcut = spans.counters().get("step.shortcut")
    steps = run.window.get("steps")
    if not steps or shortcut is None:
        return None
    return 1e3 * shortcut.s / steps
