"""Batched serving engine of the port: prefill, then step-wise decode
over a KV / SSM cache.

Counterpart of ``repro/serve/engine.py``.  PyTorch runs eagerly, so
there is nothing to jit: ``generate`` calls the model's ``prefill`` once
and its ``decode_step`` per new token, under ``torch.inference_mode``.
``make_serve_step`` and ``make_prefill_step`` are the JAX package's step
factories (the dry run counts them); with a ``mesh`` they run under it
with the rules of the run config's ``tp_mode``, and
``ServeEngine(mesh=...)`` serves params laid out on that mesh (the
prompt batch is put on it as the launchers put it, sharded on the batch
axes).  The cluster-backed request server is ``serve/server.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.registry import ModelApi, rules_for_mode
from repro_torch.sharding.partitioning import is_dtensor, mesh_context


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def make_serve_step(api: ModelApi, run: RunConfig, *, mesh=None, sample: bool = False,
                    temperature: float = 1.0):
    """decode_step(params, cache, tokens (B,1)[, generator]) ->
    (next_tokens (B,), logits (B,V), cache), the cache updated in place."""
    rules = rules_for_mode(run.tp_mode) if mesh is not None else None

    def serve_step(params, cache, tokens, generator=None):
        with mesh_context(mesh):
            logits, cache = api.decode_step(params, cache, tokens, rules=rules, mesh=mesh)
            logits = _plain(logits)
        if sample:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), logits, cache

    return serve_step


def make_prefill_step(api: ModelApi, run: RunConfig, *, mesh=None,
                      cache_len: Optional[int] = None):
    """prefill(params, batch) -> (last-token logits, cache)."""
    rules = rules_for_mode(run.tp_mode) if mesh is not None else None

    def prefill(params, batch):
        with mesh_context(mesh):
            return api.prefill(params, batch, cache_len=cache_len, rules=rules, mesh=mesh)

    return prefill


@dataclasses.dataclass
class ServeEngine:
    """Eager wrapper around prefill + decode: batched ``generate``.  With a
    ``mesh``, ``params`` are laid out on it (DTensors) and ``run``'s
    ``tp_mode`` picks the rules."""

    api: ModelApi
    params: Any
    mesh: Any = None
    run: RunConfig = dataclasses.field(default_factory=RunConfig)

    @staticmethod
    def _pick(logits: torch.Tensor, sample: bool, temperature: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if not sample:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(self, batch: Dict[str, torch.Tensor], **kw) -> torch.Tensor:
        """``_generate`` under ``torch.inference_mode`` (``no_grad`` under a
        mesh: DTensor views of params made outside inference mode cannot
        be made inside it).  See ``_generate`` for the arguments."""
        with torch.inference_mode() if self.mesh is None else torch.no_grad():
            return self._generate(batch, **kw)

    def _generate(
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
        if self.mesh is None:
            logits, cache = self.api.prefill(self.params, batch, cache_len=cache_len)
            decode = self.api.decode_step
        else:
            logits, cache = self._mesh_prefill(batch, cache_len)
            step = make_serve_step(self.api, self.run, mesh=self.mesh)
            decode = lambda params, cache, tokens: step(params, cache, tokens)[1:]  # noqa: E731
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
            logits, cache = decode(self.params, cache, nxt[:, None])
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

    def _mesh_prefill(self, batch, cache_len):
        """The prefill under the mesh, the batch put on it first; the
        logits come back as a plain tensor."""
        from repro_torch.data.pipeline import make_global_batch

        host = {k: v.cpu().numpy() for k, v in batch.items()}
        dev = make_global_batch(host, self.mesh, device=batch["tokens"].device)
        prefill = make_prefill_step(self.api, self.run, mesh=self.mesh, cache_len=cache_len)
        logits, cache = prefill(self.params, dev)
        return _plain(logits), cache
