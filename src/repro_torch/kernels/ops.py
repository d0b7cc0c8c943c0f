"""Public entries over the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Only the conv2d entry is
ported so far: the CUDA kernel on a CUDA tensor, its plain version on a
CPU tensor.  ``flash_attention`` and ``ssd`` (the Pallas kernels
``flash_attention_pallas`` and ``ssd_pallas``) are still to port.
"""
from repro_torch.kernels.conv2d import conv2d

__all__ = ["conv2d"]
