"""Synthetic CIFAR-shaped batches and LM token streams, drawn with numpy.

Counterpart of ``repro/data/pipeline.py::synthetic_cifar_batches`` and
``synthetic_token_batches``: the same generator calls in the same
order, so a seed yields the same arrays in both packages.
``make_global_batch`` puts a host batch on a mesh, sharded on its batch
axes.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_cifar_batches(
    batch: int, *, seed: int = 0, image_size: int = 32, channels: int = 3,
    num_classes: int = 10,
) -> Iterator[Dict[str, np.ndarray]]:
    """CIFAR-shaped stream whose label is a SPATIALLY SMOOTH class
    template (coarse random pattern upsampled) plus noise — local
    receptive fields + pooling can actually extract it, so a real CNN
    fits it in a few dozen steps."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(num_classes, image_size // 4, image_size // 4, channels))
    probes = coarse.repeat(4, axis=1).repeat(4, axis=2)  # low-frequency templates
    probes /= np.sqrt((probes ** 2).mean(axis=(1, 2, 3), keepdims=True))
    while True:
        labels = rng.integers(0, num_classes, size=batch)
        images = (
            rng.normal(size=(batch, image_size, image_size, channels)) * 0.5
            + probes[labels]
        )
        yield {
            "images": images.astype(np.float32),
            "labels": labels.astype(np.int32),
        }


def synthetic_token_batches(
    batch: int, seq_len: int, vocab_size: int, *, seed: int = 0,
    stream_seed: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Bigram-chain token stream: next token = perm[token] with noise, so
    an LM can drive loss well below uniform.  ``seed`` fixes the TASK
    (the permutation); ``stream_seed`` varies the samples — use the same
    seed with a different stream_seed for held-out eval data."""
    task_rng = np.random.default_rng(seed)
    perm = task_rng.permutation(vocab_size)
    rng = np.random.default_rng(stream_seed if stream_seed is not None else seed + 1)
    while True:
        toks = np.empty((batch, seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        noise = rng.random((batch, seq_len)) < 0.1
        randoms = rng.integers(0, vocab_size, size=(batch, seq_len))
        for t in range(seq_len):
            nxt = perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], randoms[:, t], nxt)
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def make_global_batch(host_batch: Dict[str, np.ndarray], mesh, batch_axes=("pod", "data"),
                      device=None) -> Dict[str, "torch.Tensor"]:
    """Host numpy batch -> DTensors on ``mesh`` sharded on the batch axes
    (those the mesh has).  Each rank holds the whole host batch, as the
    launchers draw it from one seed, and keeps its own rows: the JAX
    package's ``make_array_from_callback`` path.  ``device``: the mesh's
    device type unless given."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.local import distribute_local

    names = list(mesh.mesh_dim_names)
    placements = [Shard(0) if n in batch_axes else Replicate() for n in names]
    device = device or mesh.device_type
    return {k: distribute_local(torch.from_numpy(np.ascontiguousarray(v)).to(device), mesh,
                                placements)
            for k, v in host_batch.items()}
