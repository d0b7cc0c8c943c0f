"""serve_p50_ms: the median (nearest rank) over the same requests as
serve_p95_ms."""
from portbench import readers


def read(run):
    if "latency_s" not in run.window:
        return None
    v = readers.nearest_rank(run.window["latency_s"], 0.50)
    return None if v is None else 1e3 * v
