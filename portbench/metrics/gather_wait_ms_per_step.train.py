"""gather_wait_ms_per_step.train: the cluster's LayerTiming.gather_wait_s
over the window (the master blocked on the other devices' shards), per
step."""
from portbench import readers


def read(run):
    return readers.per_unit_ms(run, run.window["timing"]["gather_wait_s"], "steps")
