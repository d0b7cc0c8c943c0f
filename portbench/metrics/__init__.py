"""One reader a metric, ``<metric>.py``, found by the metric's name in
BENCHMARK.json; ``read(run)`` takes a ``portbench.run.Run``."""
