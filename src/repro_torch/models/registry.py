"""Model registry of the port: a uniform ``ModelApi`` over every
architecture family.

Counterpart of ``repro/models/registry.py``.  ``build_model(cfg)``
returns closures for init / forward / prefill / decode: over
``models/encdec.py`` for the encoder-decoder family (whisper), over
``models/transformer.py`` for the decoder-only ones (dense, moe, ssm,
hybrid, vlm).  The logical-axis trees the JAX launcher shards with come
with sharding.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    # init(generator, device) -> params
    init: Callable[..., Any]
    # forward(params, batch, *, remat="none", **fns) -> (logits, aux)
    forward: Callable[..., Any]
    # prefill(params, batch, *, cache_len, **fns) -> (logits, cache)
    prefill: Callable[..., Any]
    # decode_step(params, cache, tokens) -> (logits, cache)
    decode_step: Callable[..., Any]
    # init_cache(batch, seq_len, dtype=None, device=...) -> cache
    init_cache: Callable[..., Any]


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
            forward=functools.partial(encdec_lib.encdec_forward, cfg=cfg),
            prefill=functools.partial(encdec_lib.encdec_prefill, cfg=cfg),
            decode_step=functools.partial(encdec_lib.encdec_decode_step, cfg=cfg),
            init_cache=functools.partial(encdec_lib.init_encdec_cache, cfg),
        )
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device: tf_lib.init_lm(generator, cfg, device),
        forward=functools.partial(_lm_batch_forward, cfg=cfg),
        prefill=functools.partial(_lm_batch_prefill, cfg=cfg),
        decode_step=functools.partial(tf_lib.lm_decode_step, cfg=cfg),
        init_cache=functools.partial(tf_lib.init_cache, cfg),
    )
