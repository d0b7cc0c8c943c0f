"""copy_ms_per_step.train: the card's host<->device memcpy time in the
traced window, per step."""
from portbench import readers


def read(run):
    if run.trace is None:
        return None
    return readers.per_unit_ms(run, run.trace["copy_s"], "steps")
