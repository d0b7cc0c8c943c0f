"""Weights carried across from the JAX package, and back.

The JAX package's ``init_cnn`` (repro/models/cnn.py) returns a nested
dict — ``conv1``/``conv2``/``fc``, each with ``kernel`` and ``bias`` —
of jax arrays; ``np.asarray`` on each leaf turns it into the numpy tree
``params_from_numpy`` takes, and ``params_to_numpy`` turns the port's
tree of tensors back into one, so two trees compare leaf by leaf.
Layouts are kept as they are: conv kernels HWIO, dense kernels (in, out).
``lm_params_from_numpy`` does the same for the JAX package's ``init_lm``
tree, whose blocks are stacked on a leading layer axis, and
``encdec_params_from_numpy`` for its ``init_encdec`` tree;
``lm_params_to_numpy`` and ``encdec_params_to_numpy`` restack the
port's per-layer lists onto that axis, and ``opt_state_from_numpy`` /
``opt_state_to_numpy`` carry the optimizers' states across the same
way.  numpy has no bfloat16, so a bf16 tensor leaves as a ``BitView``
(its bits as uint16, and the dtype's name), which
``checkpoint/io.py`` writes as the JAX package writes a bf16 array.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class BitView(NamedTuple):
    """A leaf of a dtype numpy lacks (bfloat16, the fp8 types): its bits
    as an unsigned integer array of the same itemsize, and the dtype's
    name as the JAX package's manifest records it."""

    bits: np.ndarray
    dtype: str


def leaf_to_numpy(t):
    """A tensor (or numpy array, number or ``BitView``) on the host: a
    numpy array where numpy has the dtype, else a ``BitView``."""
    if isinstance(t, BitView):
        return t
    if not isinstance(t, torch.Tensor):
        t = np.asarray(t)
        if t.dtype.kind in "biufc":
            return t
        # a JAX array's bfloat16 / fp8 through numpy (ml_dtypes)
        return BitView(t.view(f"u{t.dtype.itemsize}"), str(t.dtype))
    t = t.detach().cpu()
    if t.dtype.is_floating_point and t.dtype not in (torch.float16, torch.float32,
                                                     torch.float64):
        ints = {1: torch.uint8, 2: torch.int16}[t.element_size()]
        bits = t.view(ints).numpy().view(f"u{t.element_size()}")
        return BitView(bits, str(t.dtype).split(".")[-1])
    return t.numpy()


def leaf_from_numpy(a, device) -> torch.Tensor:
    """A numpy array or ``BitView`` as a tensor on ``device``, with its
    dtype (a ``BitView``'s bits reinterpreted as ``torch.<dtype>``)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.device(device))
    if isinstance(a, np.ndarray) and a.dtype.kind not in "biufc":
        # a JAX array's bfloat16 / fp8 through numpy (ml_dtypes)
        a = BitView(a.view(f"u{a.dtype.itemsize}"), str(a.dtype))
    if isinstance(a, BitView):
        bits = np.array(a.bits, copy=True)
        ints = torch.from_numpy(bits.view(f"i{bits.dtype.itemsize}"))
        return ints.view(getattr(torch, a.dtype)).to(torch.device(device))
    return torch.from_numpy(np.array(a, copy=True)).to(torch.device(device))


def params_from_numpy(tree, device) -> dict:
    """Map a nested dict of numpy arrays (or ``BitView``s, or tensors) to
    torch tensors on ``device``, keeping every name, shape and dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return leaf_from_numpy(tree, device)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, BitView):
        return BitView(tree.bits[i], tree.dtype)
    if isinstance(tree, torch.Tensor):
        return tree[i]
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
    return _split_layers(tree, _layered_keys(cfg), device)


def encdec_params_from_numpy(tree, cfg, device) -> dict:
    """The port's encoder-decoder params from the JAX package's
    ``init_encdec`` tree with numpy leaves: ``enc_blocks`` and
    ``dec_blocks`` become lists of ``cfg.num_encoder_layers`` and
    ``cfg.num_layers`` per-layer dicts, every other leaf as it is."""
    return _split_layers(tree, _layered_keys(cfg), device)


def _layered_keys(cfg) -> dict:
    """The layer-list keys of ``cfg``'s param tree and their lengths."""
    if cfg.num_encoder_layers > 0:
        return {"enc_blocks": cfg.num_encoder_layers, "dec_blocks": cfg.num_layers}
    return {"blocks": cfg.num_layers}


def params_to_numpy(tree):
    """Map a nested dict of tensors to numpy arrays on the host, keeping
    every name, shape and dtype (a bf16 leaf as a ``BitView``)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return leaf_to_numpy(tree)


def _stack(leaves):
    if isinstance(leaves[0], BitView):
        return BitView(np.stack([b.bits for b in leaves]), leaves[0].dtype)
    return np.stack(leaves)


def _restack(tree):
    """The port's tree on the host in the JAX package's layout: each list
    of per-layer dicts stacked into one dict of arrays with a leading
    layer axis."""
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        layers = [_restack(v) for v in tree]

        def stack(*leaves):
            if isinstance(leaves[0], dict):
                return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
            return _stack(list(leaves))

        return stack(*layers)
    return leaf_to_numpy(tree)


def _check_layers(tree, cfg) -> None:
    for key, n in _layered_keys(cfg).items():
        if len(tree[key]) != n:
            raise ValueError(f"{cfg.arch_id}: {len(tree[key])} {key}, the config has {n}")


def lm_params_to_numpy(params, cfg) -> dict:
    """The inverse of ``lm_params_from_numpy``: the port's decoder-only
    params as the JAX package's ``init_lm`` tree with numpy leaves
    (``blocks`` stacked on a leading layer axis; bf16 leaves as
    ``BitView``s)."""
    _check_layers(params, cfg)
    return _restack(params)


def encdec_params_to_numpy(params, cfg) -> dict:
    """The inverse of ``encdec_params_from_numpy``: ``enc_blocks`` and
    ``dec_blocks`` stacked on a leading layer axis."""
    _check_layers(params, cfg)
    return _restack(params)


def opt_state_to_numpy(name: str, state, cfg) -> dict:
    """An optimizer state of ``optim/optimizers.py`` as the JAX package's
    (``sgd``: mu; ``adam``: mu, nu, count; ``adafactor``: v, count) with
    numpy leaves: the moments' layer lists restacked, adafactor's state
    (already in the JAX layout) converted, the count an int32 scalar."""
    out = {}
    for key, val in state.items():
        if key == "count":
            out[key] = np.asarray(val, dtype=np.int32)
        elif name == "adafactor":
            out[key] = _restack(val)
        else:
            _check_layers(val, cfg)
            out[key] = _restack(val)
    return out


def opt_state_from_numpy(name: str, tree, cfg, device) -> dict:
    """The inverse of ``opt_state_to_numpy``: the JAX package's optimizer
    state (numpy leaves) as the port's, on ``device``."""
    if name not in ("sgd", "adam", "adafactor"):
        raise ValueError(f"unknown optimizer {name!r}")
    out = {}
    for key, val in tree.items():
        if key == "count":
            out[key] = int(np.asarray(val))
        elif name == "adafactor":
            out[key] = params_from_numpy(val, device)
        else:
            out[key] = _split_layers(val, _layered_keys(cfg), device)
    return out


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
