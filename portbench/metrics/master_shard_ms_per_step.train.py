"""master_shard_ms_per_step.train: the program's ``cluster.master_shard``
spans (the master's own conv and VJP shards, the reads of
``LayerTiming.master_conv_s``) in the traced window, per step.  None
for a program without its own spans."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    shard = spans.counters().get("cluster.master_shard")
    steps = run.window.get("steps")
    if not steps or shard is None:
        return None
    return 1e3 * shard.s / steps
