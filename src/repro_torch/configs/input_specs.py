"""Stand-ins for every model input of the dry runs: fake tensors (shapes
and dtypes, no storage) of the JAX package's ``ShapeDtypeStruct``s.

Counterpart of ``repro/configs/input_specs.py``.  ``input_specs(cfg,
shape)`` returns the kwargs tree the step function runs on:

* train / prefill: {"tokens", "labels"} (+ "patches" for VLM, "frames"
  for audio) — the modality stubs ARE the carve-out: precomputed
  patch/frame embeddings of the frontend's output shape.
* decode: {"tokens": (B, 1)} + the cache tree from the model's
  ``init_cache`` run under ``FakeTensorMode`` (full-length KV for dense,
  window ring for SWA, O(1) state for SSM).

Tokens are int32, as in the JAX package.  The tensors belong to a
``FakeTensorMode`` (the caller's, or a new one) on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def shapes_for_arch(cfg: ModelConfig) -> List[str]:
    """Which of the four input shapes this arch runs (long_500k only with
    a sub-quadratic decode path)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, *, fake_mode=None,
                device="cpu") -> Dict[str, Any]:
    """The inputs of ``shape``'s step as fake tensors of ``fake_mode``
    (a new ``FakeTensorMode`` if None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode: Optional[FakeTensorMode] = fake_mode or FakeTensorMode()
    b, s = shape.global_batch, shape.seq_len
    with mode:
        def empty(shp, dtype):
            return torch.empty(tuple(shp), dtype=dtype, device=device)

        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {"tokens": empty((b, s), torch.int32)}
            if shape.kind == "train":
                specs["labels"] = empty((b, s), torch.int32)
            if cfg.vision is not None:
                v = cfg.vision
                specs["patches"] = empty((b, v.num_image_tokens, v.vision_dim), torch.float32)
            if cfg.audio is not None:
                a = cfg.audio
                specs["frames"] = empty((b, a.num_frames, a.frame_dim), torch.float32)
            return specs

        # decode: one token against a seq_len-sized context
        from repro_torch.models.registry import build_model  # lazy: import cycle

        api = build_model(cfg)
        cache = api.init_cache(b, s, device=device)
        return {"tokens": empty((b, 1), torch.int32), "cache": cache}
