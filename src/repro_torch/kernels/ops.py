"""Public entries over the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  The conv2d entries are
ported: the CUDA kernels on CUDA tensors, their plain versions on CPU
tensors, and ``Conv2dFunction``, the conv differentiable through them.
``flash_attention`` and ``ssd`` (the Pallas kernels
``flash_attention_pallas`` and ``ssd_pallas``) are still to port.
"""
from repro_torch.kernels.conv2d import Conv2dFunction, conv2d, conv2d_dw, conv2d_dx

__all__ = ["Conv2dFunction", "conv2d", "conv2d_dw", "conv2d_dx"]
