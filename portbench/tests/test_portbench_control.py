"""What decides ``correct``, at a tiny width on the CPU: the program
passes its cell's limits; the control (the reference in the program's
place in TF32, the precision below float32) fails one of them; and a
run with the timed path broken underneath comes out not correct, once
for each fault the cell can have."""
import numpy as np
import pytest

from portbench import run
from portbench.drivers import serve as serve_driver
from conftest import ALL_CELLS, CPU, cell_spec, tiny_spec

SEEDS = [2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9]


def _exceeds(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_program_passes_and_control_fails(cell, seed):
    s = tiny_spec(cell)
    d = s.driver().Driver(s.cell, s.cfg, seed, 0.5, "cpu", CPU)
    try:
        d.window(run.no_range)
    finally:
        d.close()
    limits = s.cell["limits"]
    assert not _exceeds(d.check(), limits)
    assert _exceeds(d.control("tf32"), limits)


def _correct(cell, **cell_over):
    result, _ = run.run_cell(tiny_spec(cell, **cell_over), SEEDS[0], 0.5, False,
                             device="cpu", backend_map=CPU)
    return result["correct"]


TRAIN = [c for c in ALL_CELLS if cell_spec(c).mode == "train"]
SERVE = [c for c in ALL_CELLS if cell_spec(c).mode == "serve"]
HETERO = [c for c in ALL_CELLS if len(cell_spec(c).cell["backends"]) > 1]


def _wrap_step(monkeypatch, wrap):
    import repro_torch.models.cnn as cnn

    orig = cnn.make_cluster_train_step
    monkeypatch.setattr(cnn, "make_cluster_train_step",
                        lambda *a, **k: wrap(orig(*a, **k)))


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    def wrap(step):
        def unchanged(params, images, labels):
            _, loss, acc = step(params, images, labels)
            return params, loss, acc
        return unchanged

    _wrap_step(monkeypatch, wrap)
    assert _correct(cell) is False


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    def wrap(step):
        def half(params, images, labels):
            n = len(images) // 2
            return step(params, images[:n], labels[:n])
        return half

    _wrap_step(monkeypatch, wrap)
    assert _correct(cell) is False


@pytest.mark.parametrize("cell", HETERO)
def test_the_exchange_with_the_cpu_device_left_out(cell, monkeypatch):
    from repro_torch.core.backends import NumpyBackend

    monkeypatch.setattr(NumpyBackend, "conv", lambda self, x, w: np.zeros(
        x.shape[:-1] + (w.shape[-1],), np.float32))
    monkeypatch.setattr(NumpyBackend, "conv_vjp", lambda self, x, w, g: (
        np.zeros(x.shape, np.float32), np.zeros(w.shape, np.float32)))
    assert _correct(cell) is False


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from repro_torch.core.cluster.scheduler import ServeChain

    orig = ServeChain.push

    def push(self, x):
        out = orig(self, x)
        if out is not None:
            out = out.copy()
            out[0] = out[0][::-1]
        return out

    monkeypatch.setattr(ServeChain, "push", push)
    assert _correct(cell) is False


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_the_answers_never_come(cell, monkeypatch):
    from repro_torch.serve.server import ClusterServer

    orig = ClusterServer._complete

    def complete(self, rec, out, failures_end):
        # after the set-up's warm-up requests, every odd one is dropped
        keep = [i for i, r in enumerate(rec.reqs)
                if r.request_id < rec_warm or r.request_id % 2 == 0]
        rec.reqs, out = [rec.reqs[i] for i in keep], out[keep]
        return orig(self, rec, out, failures_end)

    rec_warm = tiny_spec(cell).cell["max_batch"]

    monkeypatch.setattr(ClusterServer, "_complete", complete)
    monkeypatch.setattr(serve_driver, "DRAIN_S", 2.0)
    assert _correct(cell) is False
