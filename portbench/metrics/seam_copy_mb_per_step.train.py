"""seam_copy_mb_per_step.train: the bytes the cluster moved between the
host's numpy and the master's device in the traced window, in MB (1e6
bytes) per step: the program's spans ``cluster.to_host`` (the slaves'
inputs, gradient slices and kernel shards; the spatial and batch axes'
operands) and ``cluster.to_card`` (their results).  0.0 where steps ran
and nothing crossed; None for a program whose ``cluster.master_shard``
spans carry no ``operands`` label (one without the seam)."""
NAMES = ("cluster.to_host", "cluster.to_card")


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    steps = run.window.get("steps")
    if not steps or not any(s.name == "cluster.master_shard" and "operands" in s.attrs
                            for s in spans.spans()):
        return None
    c = spans.counters()
    return sum(c[n].bytes for n in NAMES if n in c) / 1e6 / steps
