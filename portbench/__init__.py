"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

One run measures one cell of ``BENCHMARK.json`` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<mode>.py`` and
``metrics/<metric>.py``.  The yardstick (traffic, work arithmetic,
trace reading, the plain reference) lives here too, so that a change
to the program cannot move it.
"""
