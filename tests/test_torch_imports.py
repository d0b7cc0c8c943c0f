"""The port stands alone: nothing under src/repro_torch/, and nothing in
chip_smoke.py, imports jax or the JAX package ``repro``, statically or
at run time."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port's modules, and chip_smoke.py, which drives the port on the card
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_has_modules():
    assert len(FILES) >= 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_port_module_imports_ml_dtypes():
    """numpy has no bfloat16, and the machine with the card has no
    ``ml_dtypes``: the port's bf16 wire stage is numpy only, and no
    module of the port (nor chip_smoke.py) imports ``ml_dtypes``."""
    bad = {str(p.relative_to(ROOT)): m for p in FILES for m in _imported_modules(p)
           if m.split(".")[0] == "ml_dtypes"}
    assert not bad, bad


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.backends")
    assert _forbidden("repro") and not _forbidden("repro_torch.core")


def test_entry_points_load_no_jax_and_no_repro_at_run_time():
    code = (
        "import sys\n"
        "import repro_torch.launch.hetero, repro_torch.core.cluster.protocol\n"
        "import repro_torch.core.backends, repro_torch.serve.server\n"
        "import repro_torch.kernels.ops, repro_torch.convert\n"
        "import repro_torch.models.cnn, repro_torch.data.pipeline\n"
        "import repro_torch.configs.cifar_cnn\n"
        "import repro_torch.launch.serve, repro_torch.serve.engine\n"
        "import repro_torch.models.registry, repro_torch.configs\n"
        "import repro_torch.kernels.flash_attn, repro_torch.kernels.ssd\n"
        "import repro_torch.core.cluster.hierarchy, repro_torch.core.costmodel\n"
        "import repro_torch.core.simulator, repro_torch.core.master_slave\n"
        "import repro_torch.layers.moe, repro_torch.models.encdec\n"
        "import repro_torch.launch.train, repro_torch.train.step, repro_torch.train.loss\n"
        "import repro_torch.optim.optimizers, repro_torch.optim.schedule\n"
        "import repro_torch.checkpoint.io, repro_torch.tree, repro_torch.models.remat\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
