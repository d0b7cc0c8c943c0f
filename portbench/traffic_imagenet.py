"""The ImageNet-shaped traffic of the chain CNN cells, drawn from
``--seed`` alone: a frozen generator of the benchmark's own, which no
change to the program can move.

``synthetic_imagenet_batches`` follows ``traffic.synthetic_cifar_batches``'
law (each label a spatially smooth class template plus noise) at
ImageNet's size without its set-up: the templates are drawn coarse, one
cell per 32x32 patch, and upsampled only for the batch's labels, so a
step draws its batch in tens of ms and set-up holds 1000 x 7 x 7 x 3
numbers, where ``synthetic_cifar_batches`` at 224x224 would first build
all 1000 full-size templates (1.2 GB).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from portbench.traffic import seed_rng

PATCH = 32  # pixels a side of one template cell


def synthetic_imagenet_batches(
    batch: int, *, seed: int, image_size: int = 224, channels: int = 3,
    num_classes: int = 1000,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of ``{"images": (batch, H, W, C) float32, "labels":
    (batch,) int32}``: labels uniform over the classes; each image its
    class's template (a standard-normal (H/32, W/32, C) grid, each cell
    repeated over a 32x32 patch, so of unit RMS) plus standard-normal
    noise times 0.5.  ``image_size`` is a multiple of 32."""
    rng = seed_rng(seed, 3)
    cells = image_size // PATCH
    coarse = rng.standard_normal((num_classes, cells, cells, channels), dtype=np.float32)
    while True:
        labels = rng.integers(0, num_classes, size=batch)
        images = rng.standard_normal((batch, image_size, image_size, channels),
                                     dtype=np.float32)
        images *= 0.5
        images += coarse[labels].repeat(PATCH, axis=1).repeat(PATCH, axis=2)
        yield {"images": images, "labels": labels.astype(np.int32)}
