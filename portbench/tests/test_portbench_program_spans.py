"""The metrics read from the program's own spans, in a tiny traced run of
each cell on the CPU (the program's cuda devices as plain PyTorch ones):
every one its cell lists reads a value but ``CudaBackend``'s copy time,
which no call made; the weight bytes read 0.0; the CPU device's shard
and the master's own shard read time; the gather wait the program's
spans sum equals the cluster's ``LayerTiming``."""
import pytest

from portbench import run
from conftest import CPU, tiny_spec

SEED = 2 ** 31 + 8191
NEW = ("host_update_ms_per_step.train", "stage_copy_ms_per_step.train",
       "backend_copy_ms_per_step.train", "backend_weight_mb_per_step.train",
       "cpu_shard_ms_per_step.train", "master_shard_ms_per_step.train")
NO_CUDA_CALL = ("backend_copy_ms_per_step.train",)


@pytest.mark.parametrize("cell", ["cnn500_train_hetero", "cnn500_train_gpu"])
def test_a_traced_run_reads_the_program_spans(cell):
    s = tiny_spec(cell)
    result, record = run.run_cell(s, SEED, 1.0, True, device="cpu", backend_map=CPU)
    assert result["correct"] is True
    got = {k: m["value"] for k, m in result["metrics"].items()}
    listed = [m["name"] for m in s.metrics(True) if m["name"] in NEW]
    assert {n for n in listed if n not in NO_CUDA_CALL} <= set(got)
    assert not set(NO_CUDA_CALL) & set(got)
    assert got["backend_weight_mb_per_step.train"] == 0.0
    assert got["host_update_ms_per_step.train"] > 0 and got["stage_copy_ms_per_step.train"] > 0
    step_ms = 1e3 * record["window"]["seconds"] / record["window"]["steps"]
    assert 0 < got["master_shard_ms_per_step.train"] <= step_ms
    if cell == "cnn500_train_hetero":
        assert got["cpu_shard_ms_per_step.train"] > 0
        assert "cpu_shard_ms_per_step.train" in listed
    else:
        assert "cpu_shard_ms_per_step.train" not in got


def test_the_summed_gather_wait_spans_are_the_cluster_s_gather_wait():
    from repro_torch.core import spans

    result, record = run.run_cell(tiny_spec("cnn500_train_hetero"), SEED + 1, 1.0, True,
                                  device="cpu", backend_map=CPU)
    assert spans.counters()["cluster.gather_wait"].s == pytest.approx(
        record["window"]["timing"]["gather_wait_s"], rel=1e-9)
    assert spans.counters()["step"].count == record["window"]["steps"]
