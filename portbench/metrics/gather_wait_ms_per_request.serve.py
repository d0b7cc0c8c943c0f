"""gather_wait_ms_per_request.serve: the cluster's
LayerTiming.gather_wait_s over the window, per answered request."""
from portbench import readers


def read(run):
    return readers.per_unit_ms(run, run.window["timing"]["gather_wait_s"], "answered_ok")
