"""plan_cpu_kernel_fraction.train reads the program's ``cluster.plan``
spans: the mean share of the widest plans' units on devices whose
backend is not ``cuda``; None where no plan span was recorded.  A tiny
traced run of the hetero cell on the CPU (its cuda device a plain
PyTorch one, so no device is ``cuda``) reads 100."""
import time

import pytest
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from portbench import run, spec
from conftest import CPU, tiny_spec

NAME = "plan_cpu_kernel_fraction.train"


def _recorded(*plans):
    """A profiler session holding one ``cluster.plan`` span per
    ``(units, cpu_units)``, beside a span of another name."""
    from repro_torch.core import spans

    spans.record("test.off", time.perf_counter(), time.perf_counter())
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)):
        t = time.perf_counter()
        spans.record("cluster.scatter", t, t + 1e-6)
        for units, cpu_units in plans:
            spans.record("cluster.plan", t, t + 1e-6, eq1="layer", units=units,
                         cpu_units=cpu_units, axis="kernel")


def test_the_widest_plans_share_is_read_from_the_spans():
    _recorded((500, 400), (1500, 150), (500, 450), (1500, 300))
    assert spec.reader(NAME).read(None) == pytest.approx(100.0 * (0.1 + 0.2) / 2)


def test_nothing_is_read_without_a_plan_span():
    _recorded()
    assert spec.reader(NAME).read(None) is None


def test_a_traced_run_of_the_hetero_cell_reads_its_plans():
    s = tiny_spec("cnn500_train_hetero")
    assert NAME in [m["name"] for m in s.metrics(True)]
    result, _ = run.run_cell(s, 2 ** 31 + 4099, 1.0, True, device="cpu", backend_map=CPU)
    assert result["correct"] is True
    assert result["metrics"][NAME]["value"] == 100.0
    assert NAME not in [m["name"] for m in tiny_spec("cnn500_train_gpu").metrics(True)]
