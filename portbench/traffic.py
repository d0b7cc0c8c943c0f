"""The traffic of the benchmark's cells, drawn from ``--seed`` alone.

``synthetic_cifar_batches`` is a frozen copy of the port's
``src/repro_torch/data/pipeline.py::synthetic_cifar_batches`` (the same
numpy calls in the same order), kept here so that a change to the
program cannot change the training cells' data.  ``serve_images``
follows the image law of ``src/repro_torch/launch/hetero.py::
serve_inputs`` (one standard-normal (H, W, 3) image a request).
``open_loop_schedule`` is the serving cells' arrival process.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of a run's seed; any
    whole number is a seed."""
    return np.random.default_rng([stream, seed % 2 ** 64])


def synthetic_cifar_batches(
    batch: int, *, seed: int = 0, image_size: int = 32, channels: int = 3,
    num_classes: int = 10,
) -> Iterator[Dict[str, np.ndarray]]:
    """CIFAR-shaped stream whose label is a spatially smooth class
    template (coarse random pattern upsampled) plus noise."""
    rng = np.random.default_rng(seed % 2 ** 64)
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


def open_loop_schedule(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of an open loop at
    ``rate_per_s`` over ``seconds``: round(rate * seconds) requests whose
    gaps are the exponential law's quantiles at (i + 1/2) / n, shuffled by
    the seed and scaled to end at ``seconds``.  Every seed sends the same
    number of requests with the same set of gaps, in another order, so
    the seed changes the arrival pattern and not the amount of work."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    seed_rng(seed, 1).shuffle(gaps)
    due = np.cumsum(gaps)
    return due * (seconds / due[-1])


def serve_images(n: int, image_size: int, channels: int, seed: int) -> np.ndarray:
    """``n`` request images, (n, H, W, C) float32 standard normal."""
    return seed_rng(seed, 2).standard_normal(
        (n, image_size, image_size, channels), dtype=np.float32)
