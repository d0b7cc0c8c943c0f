"""Synthetic CIFAR-shaped batches, drawn with numpy.

Counterpart of ``repro/data/pipeline.py::synthetic_cifar_batches``: the
same generator calls in the same order, so a seed yields the same
arrays in both packages.  The token stream and ``make_global_batch``
come with the model zoo.
"""
from __future__ import annotations

from typing import Dict, Iterator

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
