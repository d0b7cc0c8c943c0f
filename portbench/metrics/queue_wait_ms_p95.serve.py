"""queue_wait_ms_p95.serve: the 95th percentile (nearest rank) of
ServeResponse.queued_s, submit to the request's first slab, over the
answered requests."""
from portbench import readers


def read(run):
    if "queued_s" not in run.window:
        return None
    v = readers.nearest_rank(run.window["queued_s"], 0.95)
    return None if v is None else 1e3 * v
