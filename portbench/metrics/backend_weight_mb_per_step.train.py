"""backend_weight_mb_per_step.train: the bytes of conv kernels
``CudaBackend`` copied to the card (``w`` of ``cuda.to_card``) and of
kernel gradients it copied back (``dw`` of ``cuda.to_host``) in the
traced window, in MB (1e6 bytes) per step: 0.0 where steps ran and no
``CudaBackend`` call did; None for a program without its own spans."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    c = spans.counters()
    steps = run.window.get("steps")
    if not steps or "step" not in c:
        return None
    moved = (c["cuda.to_card"].bytes_by.get("w", 0) if "cuda.to_card" in c else 0) + (
        c["cuda.to_host"].bytes_by.get("dw", 0) if "cuda.to_host" in c else 0)
    return moved / 1e6 / steps
