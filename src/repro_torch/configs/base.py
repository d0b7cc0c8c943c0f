"""Config dataclasses of the port.

Counterpart of ``repro/configs/base.py``; only ``CNNConfig``, the
paper's network, is ported so far.  Same fields, same defaults.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """The paper's CIFAR-10 network: conv(5x5,c1) -> norm -> pool/2 ->
    conv(5x5,c2) -> norm -> pool/2 -> FC -> softmax."""

    arch_id: str
    c1_kernels: int
    c2_kernels: int
    kernel_size: int = 5
    image_size: int = 32
    image_channels: int = 3
    num_classes: int = 10
    pool_stride: int = 2
    dtype: str = "float32"
    family: str = "cnn"
