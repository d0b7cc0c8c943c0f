"""The paper's pre-processing probe (§4.1.1), over the port's conv.

Counterpart of ``repro/core/profiling.py``, with its signatures.  Before
training, every device runs a convolution with the real image and
kernel sizes, on random values ("only the time spent performing
calculations is relevant"), and reports the elapsed time to the master;
Eq. 1 converts the times into workload shares.  The convolution is the
port's (``kernels.ops.conv2d``): K1 on the card (``device="cuda"``, the
default; an error without a card, never a CPU fallback), its plain
version on ``device="cpu"``.

A *slowdown factor* per emulated device lets tests and examples
reproduce heterogeneous clusters deterministically: a device with
slowdown 2.0 reports twice its measured time, as a device half as fast
would.  The cluster itself probes through ``core/backends.py::
probe_conv_time``, as the JAX package's does; this module is the
standalone probe.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.ops import conv2d


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_conv_time(
    *,
    image_size: int,
    in_channels: int,
    kernel_size: int,
    num_kernels: int,
    batch: int,
    repeats: int = 3,
    slowdown: float = 1.0,
    seed: int = 0,
    device: str = "cuda",
) -> float:
    """Run the conv on ``device`` and return the median elapsed seconds of
    ``repeats`` timed runs (one untimed run first: the kernel's build and
    first launch), times ``slowdown`` where it exceeds 1."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_conv_time: device 'cuda' needs a CUDA card and "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, image_size, image_size, in_channels), generator=g).to(dev)
    w = torch.randn((kernel_size, kernel_size, in_channels, num_kernels), generator=g).to(dev)
    conv2d(x, w)
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        conv2d(x, w)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    measured = float(np.median(times))
    if slowdown > 1.0:
        # emulate a slower device: it would have taken slowdown x longer
        measured *= slowdown
    return measured


def probe_devices(
    num_devices: int,
    *,
    image_size: int = 32,
    in_channels: int = 3,
    kernel_size: int = 5,
    num_kernels: int = 100,
    batch: int = 64,
    slowdowns: Optional[Sequence[float]] = None,
    device: str = "cuda",
) -> list:
    """Probe every emulated device (the master's §4.1.1 pre-processing)."""
    slowdowns = slowdowns or [1.0] * num_devices
    assert len(slowdowns) == num_devices
    return [
        probe_conv_time(
            image_size=image_size,
            in_channels=in_channels,
            kernel_size=kernel_size,
            num_kernels=num_kernels,
            batch=batch,
            slowdown=s,
            seed=i,
            device=device,
        )
        for i, s in enumerate(slowdowns)
    ]
