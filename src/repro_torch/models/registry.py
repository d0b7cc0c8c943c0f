"""Model registry of the port: a uniform ``ModelApi`` over every
architecture family.

Counterpart of ``repro/models/registry.py``.  ``build_model(cfg)``
returns closures for init / forward / prefill / decode: over
``models/encdec.py`` for the encoder-decoder family (whisper), over
``models/transformer.py`` for the decoder-only ones (dense, moe, ssm,
hybrid, vlm), plus the logical-axis trees the launchers shard params
and caches with (``param_axes``, ``cache_axes``: the port's layout,
one layer's axes standing for every layer of a list).
``rules_for_mode`` maps ``--tp-mode`` to its rule table.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.sharding.axes import (
    LOGICAL_RULES_FSDP,
    LOGICAL_RULES_GATHER,
    LOGICAL_RULES_MEGATRON,
    LOGICAL_RULES_ZERO1,
    AxisRules,
)

TP_MODES = ("megatron", "gather", "fsdp", "zero1")


def rules_for_mode(tp_mode: str) -> AxisRules:
    if tp_mode == "gather":
        return LOGICAL_RULES_GATHER
    if tp_mode == "megatron":
        return LOGICAL_RULES_MEGATRON
    if tp_mode == "fsdp":
        return LOGICAL_RULES_FSDP
    if tp_mode == "zero1":
        return LOGICAL_RULES_ZERO1
    raise ValueError(f"unknown tp_mode {tp_mode!r}")


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    # init(generator, device) -> params
    init: Callable[..., Any]
    # param_axes() -> logical axes of init's params
    param_axes: Callable[[], Any]
    # forward(params, batch, *, remat="none", rules=None, mesh=None, **fns)
    #   -> (logits, aux)
    forward: Callable[..., Any]
    # prefill(params, batch, *, cache_len, rules=None, mesh=None, **fns)
    #   -> (logits, cache)
    prefill: Callable[..., Any]
    # decode_step(params, cache, tokens, *, rules=None, mesh=None) -> (logits, cache)
    decode_step: Callable[..., Any]
    # init_cache(batch, seq_len, dtype=None, device=...) -> cache
    init_cache: Callable[..., Any]
    # cache_axes() -> logical axes of init_cache's entries
    cache_axes: Callable[[], Any]


def _lm_batch_forward(params, batch, *, cfg, positions=None, **fns):
    return tf_lib.lm_forward(params, batch["tokens"], cfg=cfg,
                             patches=batch.get("patches"), positions=positions, **fns)


def _lm_batch_prefill(params, batch, *, cfg, cache_len=None, **fns):
    return tf_lib.lm_prefill(params, batch["tokens"], cfg=cfg,
                             patches=batch.get("patches"), cache_len=cache_len, **fns)


def build_model(cfg: ModelConfig) -> ModelApi:
    """``**fns`` of ``forward`` and ``prefill``: ``attention_fn`` (and,
    for the decoder-only families, ``ssd_fn``), the kernels K4 and K5
    unless given.  ``forward`` also takes ``remat`` (``none | full |
    dots``), and the decoder-only ``forward`` ``positions``."""
    if cfg.num_encoder_layers > 0:
        return ModelApi(
            cfg=cfg,
            init=lambda generator, device: encdec_lib.init_encdec(generator, cfg, device),
            param_axes=functools.partial(encdec_lib.encdec_axes, cfg),
            forward=functools.partial(encdec_lib.encdec_forward, cfg=cfg),
            prefill=functools.partial(encdec_lib.encdec_prefill, cfg=cfg),
            decode_step=functools.partial(encdec_lib.encdec_decode_step, cfg=cfg),
            init_cache=functools.partial(encdec_lib.init_encdec_cache, cfg),
            cache_axes=encdec_lib.encdec_cache_axes,
        )
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device: tf_lib.init_lm(generator, cfg, device),
        param_axes=functools.partial(tf_lib.lm_axes, cfg),
        forward=functools.partial(_lm_batch_forward, cfg=cfg),
        prefill=functools.partial(_lm_batch_prefill, cfg=cfg),
        decode_step=functools.partial(tf_lib.lm_decode_step, cfg=cfg),
        init_cache=functools.partial(tf_lib.init_cache, cfg),
        cache_axes=functools.partial(tf_lib.cache_axes, cfg),
    )
