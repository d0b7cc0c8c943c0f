"""Rematerialisation of a block for training: the port's counterpart of
the ``jax.checkpoint`` policies of ``repro/models/transformer.py::
_scan_blocks`` and ``repro/models/encdec.py``.

``none`` saves every activation the backward needs; ``full`` saves only
the block's inputs and reruns its forward in the backward
(``torch.utils.checkpoint``, non-reentrant); ``dots`` saves the outputs
of the matmuls without batch dimensions (``aten.mm``, the dense
projections) and reruns the rest, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.  Remat
changes no number, only what is kept and what is recomputed.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_MODES = ("none", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(fn, remat: str):
    """``fn`` under the ``remat`` policy (``REMAT_MODES``)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat {remat!r}, want one of {REMAT_MODES}")
