"""The docstring gate (tools/check_docstrings.py) over the port: every
public symbol of ``repro_torch.core.cluster`` (the hierarchy included)
and ``repro_torch.serve`` is documented, as the JAX package's are
(tests/test_docstring_gate.py)."""
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, os.fspath(REPO))

from tools import check_docstrings  # noqa: E402

ROOTS = ["src/repro_torch/core/cluster", "src/repro_torch/serve"]


def test_port_cluster_and_serve_api_fully_documented(capsys):
    assert check_docstrings.main(ROOTS) == 0, capsys.readouterr().out
    n_files = sum(1 for r in ROOTS for _ in (REPO / r).rglob("*.py"))
    assert f"{n_files} files, 0 undocumented" in capsys.readouterr().err
    assert (REPO / ROOTS[0] / "hierarchy.py").exists()
