"""backend_copy_ms_per_step.train: the program's spans ``cuda.to_card``
and ``cuda.to_host`` (``CudaBackend``'s copies of operands and results,
host time with pageable staging; the card's memcpy time is
``copy_ms_per_step.train``) in the traced window, per step.  None where
no ``CudaBackend`` call ran, or for a program without its own spans."""
NAMES = ("cuda.to_card", "cuda.to_host")


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
