"""Checkpoints of the port, in the JAX package's on-disk format.

Counterpart of ``repro/checkpoint/io.py``: a flat key/value ``.npz`` per
step directory (``step_%08d/arrays.npz``, keys the tree's paths joined
by "/", list items by index) and a ``manifest.json`` of the step, the
sorted keys and each key's dtype; a dtype numpy lacks (bfloat16, fp8)
is stored as its unsigned-integer bits, the true dtype in the manifest.
So a tree the port writes in the JAX package's layout
(``convert.lm_params_to_numpy`` and ``opt_state_to_numpy``) restores
under ``repro.checkpoint.io.restore_checkpoint``, and a checkpoint the
JAX package wrote restores here, into torch tensors (bf16 read back
through ``Tensor.view``).  ``restore_checkpoint(shardings=..., mesh=...)``
lays the restored leaves out on a mesh (a tree of DTensor placements,
as ``sharding/partitioning.py::param_sharding_for_tree`` gives).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np

from repro_torch.convert import BitView, leaf_from_numpy, leaf_to_numpy

_SEP = "/"


def _flatten(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}{_SEP}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, BitView):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}{_SEP}")
    else:
        yield prefix.rstrip(_SEP), tree


def _unflatten(flat: dict) -> Any:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write the tree (tensors, numpy arrays or ``BitView``s) to
    <ckpt_dir>/step_<n>/arrays.npz (+manifest).  A dtype numpy lacks is
    stored as its bits, with the true dtype in the manifest."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = {k: leaf_to_numpy(v) for k, v in _flatten(tree)}
    dtypes = {k: v.dtype if isinstance(v, BitView) else str(v.dtype)
              for k, v in flat.items()}
    stored = {k: v.bits if isinstance(v, BitView) else v for k, v in flat.items()}
    np.savez(os.path.join(path, "arrays.npz"), **stored)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat), "dtypes": dtypes}, f, indent=1)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
    ]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       device="cpu", shardings: Any = None, mesh=None) -> Any:
    """Load a checkpoint (the latest step unless ``step``) as a tree of
    dicts of torch tensors on ``device``, each in the manifest's dtype;
    with ``shardings`` (a matching tree of DTensor placements) and a
    ``mesh``, as DTensors laid out on it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {}
        for k in z.files:
            v = z[k]
            want = manifest["dtypes"].get(k, str(v.dtype))
            if want != str(v.dtype):
                v = BitView(v, want)
            flat[k] = leaf_from_numpy(v, device)
    tree = _unflatten(flat)
    if shardings is not None:
        from repro_torch.sharding.partitioning import distribute_tree

        tree = distribute_tree(tree, mesh, shardings)
    return tree
