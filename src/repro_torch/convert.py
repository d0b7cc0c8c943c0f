"""Weights carried across from the JAX package, and back.

The JAX package's ``init_cnn`` (repro/models/cnn.py) returns a nested
dict — ``conv1``/``conv2``/``fc``, each with ``kernel`` and ``bias`` —
of jax arrays; ``np.asarray`` on each leaf turns it into the numpy tree
``params_from_numpy`` takes, and ``params_to_numpy`` turns the port's
tree of tensors back into one, so two trees compare leaf by leaf.
Layouts are kept as they are: conv kernels HWIO, dense kernels (in, out).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def params_from_numpy(tree, device) -> dict:
    """Map a nested dict of numpy arrays to torch tensors on ``device``,
    keeping every name, shape and dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(torch.device(device))


def params_to_numpy(tree):
    """Map a nested dict of tensors to numpy arrays on the host, keeping
    every name, shape and dtype."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def serve_weights(params) -> Tuple[List[np.ndarray], np.ndarray]:
    """The serve lane's inputs from a CNN param tree (numpy or torch
    leaves): the conv kernel list for ``ClusterServer(layer_weights=...)``
    and the fc matrix of the head, as float32 numpy arrays."""
    kernels = [_to_numpy(params[name]["kernel"]) for name in ("conv1", "conv2")]
    return kernels, _to_numpy(params["fc"]["kernel"])
