"""Batched serving demo on the PyTorch port: prefill a batch of prompts
and decode with the KV-cache engine across three cache regimes — full
attention (yi-style), sliding-window ring buffer (mistral-style), and
O(1) SSM state (mamba2) — printing cache memory per sequence to show the
long-context scaling the decode shapes (decode_32k / long_500k) rely on.

On ``--device cuda`` (the default) each prefill runs the hand-written
kernels: flash attention (K4) in the two attention regimes, the SSD scan
(K5) in the SSM one; on ``--device cpu`` their plain versions.  Sampling
draws from a ``torch.Generator``, so the sampled tokens are not the JAX
package's.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig, SSMConfig
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine

# the cache's position counter "t": a Python int in the port's cache, an
# int32 scalar in the JAX package's
POSITION_BYTES = 4


def cache_bytes(cache) -> int:
    """Bytes of a cache's tensors, from their shapes and dtypes (a cache
    made on the ``meta`` device holds no memory), and its position."""
    return POSITION_BYTES + sum(
        t.numel() * t.element_size() for t in cache.values() if torch.is_tensor(t)
    )


def cache_bytes_per_seq(api, batch: int, seq_len: int) -> float:
    return cache_bytes(api.init_cache(batch, seq_len, device="meta")) / batch


def regimes():
    """(name, config) of the three cache regimes."""
    base = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                d_ff=512, vocab_size=1024, head_dim=64,
                dtype="float32", param_dtype="float32")
    ssm_base = dict(base, num_heads=0, num_kv_heads=0, d_ff=0)
    return [
        ("full-attention (yi-style)", ModelConfig(
            arch_id="serve-dense", family="dense", **base)),
        ("sliding-window (mistral)", ModelConfig(
            arch_id="serve-swa", family="dense", sliding_window=16, **base)),
        ("SSM O(1) state (mamba2)", ModelConfig(
            arch_id="serve-ssm", family="ssm",
            ssm=SSMConfig(d_state=16, head_dim=32, chunk_size=16), **ssm_base)),
    ]


def demo(name: str, cfg: ModelConfig, batch=4, prompt=32, new=24, device="cuda"):
    """Serve one regime; returns its tok/s, cache KiB per sequence and
    the first sequence's first 8 tokens."""
    device = torch.device(device)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, prompt)).astype(np.int32)).to(device)
    engine = ServeEngine(api=api, run=RunConfig(), params=params)

    t0 = time.time()
    out = engine.generate({"tokens": toks}, max_new_tokens=new, sample=True,
                          temperature=0.8, seed=1).cpu()
    dt = time.time() - t0

    per_seq = cache_bytes_per_seq(api, batch, prompt + new)
    sample = out[0, :8].tolist()
    print(f"{name:28s} {batch*new/dt:7.1f} tok/s  cache/seq={per_seq/2**10:8.1f} KiB"
          f"  sample: {sample}")
    return {"tok_s": batch * new / dt, "cache_kib_per_seq": per_seq / 2**10,
            "seconds": dt, "sample": sample}


def main(argv=None):
    """The three regimes; returns each one's numbers by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the hand-written kernels; the default) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --device cuda (the default) needs a CUDA "
                         "card; pass --device cpu to run on the CPU")
    out = {name: demo(name, cfg, device=args.device) for name, cfg in regimes()}
    print("\nNote the cache scaling: full grows with context, SWA is capped "
          "at the window, SSM is constant — the long_500k enabler.")
    return out


if __name__ == "__main__":
    main()
