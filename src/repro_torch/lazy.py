"""PEP 562 lazy-module helper: one implementation for every package
whose ``__init__`` must stay import-light (TCP slave subprocesses import
``repro_torch.core.cluster.protocol`` and must stay numpy-light)."""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple


def lazy_exports(
    module_name: str, module_globals: dict, exports: Dict[str, str]
) -> Tuple[Callable, Callable]:
    """Build the ``(__getattr__, __dir__)`` pair for a lazy package.

    ``exports`` maps attribute name -> module path (absolute, or
    relative like ``".cluster"`` resolved against ``module_name``).
    Resolved attributes are cached in ``module_globals`` so each import
    cost is paid once."""

    def __getattr__(name: str):
        if name in exports:
            mod = importlib.import_module(exports[name], module_name)
            val = getattr(mod, name)
            module_globals[name] = val
            return val
        raise AttributeError(
            f"module {module_name!r} has no attribute {name!r}"
        )

    def __dir__():
        return sorted(set(module_globals) | set(exports))

    return __getattr__, __dir__
