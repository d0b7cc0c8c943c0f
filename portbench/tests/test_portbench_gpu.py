"""The control on the card at each cell's own size: the program's
numbers within the cell's limits, the control's (the reference in TF32
in the program's place) beyond one of them.  Needs a CUDA card; run as
``python -m pytest -m gpu portbench/tests/test_portbench_gpu.py``."""
import pytest

from portbench import spec
from portbench.spans import no_range

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = spec.load(cell)
    d = s.driver().Driver(s.cell, s.cfg, 2 ** 31 + 55, 2.0, "cuda")
    try:
        d.window(no_range)
    finally:
        d.close()
    limits = s.cell["limits"]
    assert all(v <= limits[k] for k, v in d.check().items())
    assert any(not v <= limits[k] for k, v in d.control("tf32").items())
