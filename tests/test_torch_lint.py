"""reprolint over the port's cluster, serve and launch modules.

The six checkers of tools/lint/ that expose ``check_source`` gate
``src/repro/`` only; this runs each of them over
``src/repro_torch/core/cluster/*.py``, ``serve/*.py`` and
``launch/*.py`` and applies the inline waivers (each with its
justification, as in the JAX package).  No violation may survive.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.lint.checkers import (  # noqa: E402
    auth_unpickle,
    blocking_lock,
    clock_injection,
    future_resolution,
    resource_hygiene,
    thread_hygiene,
)
from tools.lint.core import apply_waivers  # noqa: E402

PORT = ROOT / "src" / "repro_torch"
FILES = [p for d in ("core/cluster", "serve", "launch") for p in sorted((PORT / d).glob("*.py"))]
CHECKERS = (clock_injection, auth_unpickle, thread_hygiene, future_resolution,
            resource_hygiene, blocking_lock)


def test_the_port_has_the_modules_to_lint():
    names = {p.relative_to(PORT).as_posix() for p in FILES}
    assert {"core/cluster/transport.py", "core/cluster/cluster.py",
            "core/cluster/codec.py", "serve/server.py", "launch/hetero.py"} <= names


@pytest.mark.parametrize("checker", CHECKERS, ids=lambda c: c.NAME)
def test_no_violation_survives_the_waivers(checker):
    found = [v for p in FILES for v in checker.check_source(p, p.read_text(), ROOT)]
    survivors, _ = apply_waivers(found, ROOT)
    assert not survivors, "\n".join(map(str, survivors))
