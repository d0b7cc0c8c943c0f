"""Public entries over the port's kernels.

Counterpart of ``repro/kernels/ops.py``: the CUDA kernels on CUDA
tensors, their plain versions on CPU tensors.  ``conv2d``, ``conv2d_dx``
and ``conv2d_dw`` (K1-K3) and ``Conv2dFunction``, the conv
differentiable through them; ``flash_attention`` (K4) and ``ssd`` (K5),
the model zoo's attention and Mamba-2 scan.
"""
from repro_torch.kernels.conv2d import Conv2dFunction, conv2d, conv2d_dw, conv2d_dx
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.ssd import ssd

__all__ = ["Conv2dFunction", "conv2d", "conv2d_dw", "conv2d_dx",
           "flash_attention", "ssd"]
