"""cpu_shard_ms_per_step.train: the program's ``device.shard`` spans of
devices whose backend is not ``cuda`` (each op's compute on an
in-process slave, its emulated slowdown left out) in the traced window,
per step.  None where no such device computed, or for a program without
its own spans."""


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    shard = spans.counters().get("device.shard")
    steps = run.window.get("steps")
    cpu = [s for (label, value), s in (shard.s_by.items() if shard else ())
           if label == "backend" and value != "cuda"]
    if not steps or not cpu:
        return None
    return 1e3 * sum(cpu) / steps
