"""The import rule: the reference imports nothing of the program, and
no file of the harness imports JAX or the JAX package; the whole top-level
name is compared, so ``repro_torch`` is not ``repro``."""
import ast
import pathlib

import pytest

from portbench import run

HERE = pathlib.Path(__file__).resolve().parents[1]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_file_of_the_harness_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & {"repro", "jax", "jaxlib", "flax"}, path


def test_the_run_names_each_forbidden_module_by_its_whole_top_level_name():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models", "numpy",
                                  "jaxtyping", "reproduce"]) == []
    assert run.forbidden_modules(["jax.numpy", "repro.models", "flax", "jaxlib",
                                  "torch"]) == ["flax", "jax", "jaxlib", "repro"]


def test_this_process_holds_none():
    assert run.forbidden_modules() == []
