"""activation_mb_per_step.train: the bytes of activations and their
gradients that crossed between the host and the master's device in the
traced window, in MB (1e6 bytes) per step: the program's spans
``step.to_card`` and ``step.to_host`` (the stages' and the head's) and
the operands ``x`` and ``g`` of ``cuda.to_card`` and ``y`` and ``dx`` of
``cuda.to_host`` (``CudaBackend``'s; its kernels and their gradients are
``backend_weight_mb_per_step.train``'s).  None for a program without
its own spans."""
ACTIVATIONS = {"cuda.to_card": ("x", "g"), "cuda.to_host": ("y", "dx")}


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    c = spans.counters()
    steps = run.window.get("steps")
    if not steps or "step" not in c:
        return None
    moved = sum(c[n].bytes for n in ("step.to_card", "step.to_host") if n in c)
    for name, operands in ACTIVATIONS.items():
        if name in c:
            moved += sum(c[name].bytes_by.get(op, 0) for op in operands)
    return moved / 1e6 / steps
