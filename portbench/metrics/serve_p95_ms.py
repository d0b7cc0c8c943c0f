"""serve_p95_ms: the 95th percentile (nearest rank) over every request
due in the window, each from its due time to its response; a request
that was not answered ok counts as missing every limit."""
from portbench import readers


def read(run):
    if "latency_s" not in run.window:
        return None
    v = readers.nearest_rank(run.window["latency_s"], 0.95)
    return None if v is None else 1e3 * v
