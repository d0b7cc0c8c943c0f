"""Weights carried across from the JAX package, and back.

The JAX package's ``init_cnn`` (repro/models/cnn.py) returns a nested
dict — ``conv1``/``conv2``/``fc``, each with ``kernel`` and ``bias`` —
of jax arrays; ``np.asarray`` on each leaf turns it into the numpy tree
``params_from_numpy`` takes, and ``params_to_numpy`` turns the port's
tree of tensors back into one, so two trees compare leaf by leaf.
Layouts are kept as they are: conv kernels HWIO, dense kernels (in, out).
``lm_params_from_numpy`` does the same for the JAX package's ``init_lm``
tree, whose blocks are stacked on a leading layer axis, and
``encdec_params_from_numpy`` for its ``init_encdec`` tree.
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


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _split_layers(tree, stacked: dict, device) -> dict:
    """``tree`` with each key of ``stacked`` (a leading layer axis of the
    given length) turned into a list of per-layer dicts."""
    out = {k: params_from_numpy(v, device) for k, v in tree.items() if k not in stacked}
    for key, n in stacked.items():
        out[key] = [params_from_numpy(_layer(tree[key], i), device) for i in range(n)]
    return out


def lm_params_from_numpy(tree, cfg, device) -> dict:
    """The port's decoder-only params from the JAX package's ``init_lm``
    tree with numpy leaves: every leaf kept as it is (``wq`` (d, h, hd),
    ``wo`` (h, hd, d), ``in_proj`` (d, 2*d_in + 2*g*n + nh), a MoE
    block's float32 ``router`` (d, E) and ``w_in``/``w_gate`` (E, d, ff),
    ``w_out`` (E, ff, d), the VLM ``projector``'s ``fc1``/``fc2`` with
    their biases, ...), except that ``blocks``, stacked on a leading
    layer axis, becomes a list of ``cfg.num_layers`` per-layer dicts."""
    return _split_layers(tree, {"blocks": cfg.num_layers}, device)


def encdec_params_from_numpy(tree, cfg, device) -> dict:
    """The port's encoder-decoder params from the JAX package's
    ``init_encdec`` tree with numpy leaves: ``enc_blocks`` and
    ``dec_blocks`` become lists of ``cfg.num_encoder_layers`` and
    ``cfg.num_layers`` per-layer dicts, every other leaf as it is."""
    return _split_layers(tree, {"enc_blocks": cfg.num_encoder_layers,
                                "dec_blocks": cfg.num_layers}, device)


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
