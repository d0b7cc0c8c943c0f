"""Batched serving engine of the port: prefill, then step-wise decode
over a KV / SSM cache.

Counterpart of ``repro/serve/engine.py::ServeEngine``.  PyTorch runs
eagerly, so there is nothing to jit: ``generate`` calls the model's
``prefill`` once and its ``decode_step`` per new token, under
``torch.inference_mode``.  The JAX engine's mesh and run config (its
axis rules) come with sharding.  The cluster-backed request server is
``serve/server.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.models.registry import ModelApi


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class ServeEngine:
    """Eager wrapper around prefill + decode: batched ``generate``."""

    api: ModelApi
    params: Any

    @staticmethod
    def _pick(logits: torch.Tensor, sample: bool, temperature: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if not sample:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        *,
        max_new_tokens: int,
        cache_len: Optional[int] = None,
        sample: bool = False,
        temperature: float = 1.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        timings: Optional[dict] = None,
    ) -> torch.Tensor:
        """Prefill the prompt batch then decode greedily or sampled.
        Returns generated tokens (B, max_new_tokens) int32.

        ``batch`` holds ``tokens`` (B, S) and, whatever the model takes
        beside them, a VLM's ``patches`` or the encoder-decoder's
        ``frames``: the whole batch goes to the model's prefill.

        Sampling draws from a ``torch.Generator`` seeded with ``seed``
        (on the logits' device), so it does not give jax's bits.
        ``cache_len`` sizes the cache (default: prompt plus new tokens);
        once a row has emitted ``eos_id``, every later token of that row
        is ``eos_id``, as in the JAX engine.  With a
        ``timings`` dict, the device is synchronised after the prefill
        and after the last step, and ``prefill_s``, ``decode_s`` and
        ``decode_steps`` are written into it."""
        b, s = batch["tokens"].shape
        cache_len = cache_len or (s + max_new_tokens)
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.params, batch, cache_len=cache_len)
        generator = None
        if sample:
            generator = torch.Generator(device=logits.device).manual_seed(seed)
        nxt = self._pick(logits, sample, temperature, generator)
        if timings is not None:
            _sync(nxt)
            t1 = time.perf_counter()
            timings["prefill_s"] = t1 - t0
        out = [nxt]
        done = (torch.zeros((b,), dtype=torch.bool, device=nxt.device)
                if eos_id is not None else None)
        for _ in range(max_new_tokens - 1):
            logits, cache = self.api.decode_step(self.params, cache, nxt[:, None])
            nxt = self._pick(logits, sample, temperature, generator)
            if eos_id is not None:
                done = done | (out[-1] == eos_id)
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            out.append(nxt)
        result = torch.stack(out, dim=1).to(torch.int32)
        if timings is not None:
            _sync(result)
            timings["decode_s"] = time.perf_counter() - t1
            timings["decode_steps"] = max_new_tokens - 1
        return result
