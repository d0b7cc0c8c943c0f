"""The work arithmetic the rooflines and train_mfu read."""
import json
import os

import pytest

from portbench import work

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def _cfg(name):
    return json.load(open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")))


def test_train_step_of_the_headline_network():
    # conv1 fwd + dW, conv2 fwd + dX + dW, the fc's three products, batch 32
    assert work.train_step_flops(_cfg("cifar_cnn_500_1500"), 32) == 926_699_520_000


def test_served_image_of_the_150_800_network():
    assert work.serve_image_flops(_cfg("cifar_cnn_150_800")) == 1_560_064_000


@pytest.mark.parametrize("kind,elems", [("fwd", 8 * 16 * 16 * (500 + 1500) + 25 * 500 * 1500),
                                        ("dx", 8 * 16 * 16 * (500 + 1500) + 25 * 500 * 1500),
                                        ("dw", 8 * 16 * 16 * (500 + 1500) + 25 * 500 * 1500)])
def test_conv_work_reads_and_writes_each_operand_once(kind, elems):
    flops, nbytes = work.conv_work(kind, 8, 16, 16, 500, 1500, 5)
    assert flops == 2.0 * 8 * 16 * 16 * 25 * 500 * 1500
    assert nbytes == 4 * elems


def test_call_bound_takes_the_larger_term():
    # conv2 of a microbatch of 8: compute-bound
    fwd = work.call_bound_s("conv", (8, 16, 16, 500), (5, 5, 500, 1500))
    assert fwd == pytest.approx(2.0 * 8 * 256 * 25 * 500 * 1500 / work.PEAK_FP32_FLOPS)
    assert work.call_bound_s("conv_vjp", (8, 16, 16, 500), (5, 5, 500, 1500)) == \
        pytest.approx(2 * fwd)
    # one output channel over one pixel: bytes-bound
    tiny = work.call_bound_s("conv", (1, 1, 1, 1), (1, 1, 1, 1))
    assert tiny == pytest.approx(12 / work.PEAK_BYTES_S)
