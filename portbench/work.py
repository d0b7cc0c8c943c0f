"""The work arithmetic of the benchmark: peaks, a conv call's operations
and bytes, the roofline bound, and the operations a model step requires.

Frozen copy of ``chip_smoke.py``'s ``PEAK_FLOPS``/``PEAK_BYTES_S``,
``conv_work`` and ``bound`` (fp32 only: the CNN cells run in float32),
so that a later change to the program cannot move the yardstick.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): fp32 on
# the CUDA cores (K1-K3 compute IEEE fp32 there), HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
FP32_BYTES = 4


def conv_work(kind: str, b: int, h: int, w: int, cin: int, cout: int, k: int):
    """(operations, bytes) of one SAME stride-1 conv (``fwd``), its dX
    (``dx``) or its dW (``dw``) in float32: 2*B*H*W*k*k*Cin*Cout
    operations each; every input read once and the output written once."""
    flops = 2.0 * b * h * w * k * k * cin * cout
    x, wt, y = b * h * w * cin, k * k * cin * cout, b * h * w * cout
    elems = {"fwd": x + wt + y, "dx": y + wt + x, "dw": x + y + wt}[kind]
    return flops, FP32_BYTES * elems


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over fp32's peak
    or bytes over HBM's rate, the larger."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)


def call_bound_s(kind: str, x_shape, w_shape) -> float:
    """The bound of one backend call from its argument shapes: ``conv``
    (x, w) is the forward; ``conv_vjp`` (x, w, g) is dX's plus dW's."""
    b, h, w, cin = x_shape
    k, _, _, cout = w_shape
    if kind == "conv":
        return bound_s(*conv_work("fwd", b, h, w, cin, cout, k))
    return (bound_s(*conv_work("dx", b, h, w, cin, cout, k))
            + bound_s(*conv_work("dw", b, h, w, cin, cout, k)))


def _layer_flops(cfg: dict) -> tuple:
    """(conv1, conv2, fc) forward operations of ONE image."""
    k, s, n = cfg["kernel_size"], cfg["image_size"], cfg["image_channels"]
    c1, c2 = cfg["c1_kernels"], cfg["c2_kernels"]
    s2, s3 = s // cfg["pool_stride"], s // cfg["pool_stride"] ** 2
    conv1 = 2.0 * s * s * k * k * n * c1
    conv2 = 2.0 * s2 * s2 * k * k * c1 * c2
    fc = 2.0 * s3 * s3 * c2 * cfg["num_classes"]
    return conv1, conv2, fc


def train_step_flops(cfg: dict, batch: int) -> float:
    """Operations one SGD step of the paper's CNN requires, from the
    configuration's shapes: conv1's forward and dW (the images need no
    dX), conv2's forward, dX and dW, the fc's three products."""
    conv1, conv2, fc = _layer_flops(cfg)
    return batch * (2 * conv1 + 3 * conv2 + 3 * fc)


def serve_image_flops(cfg: dict) -> float:
    """Operations one served image requires: conv1, conv2 and the fc
    head's forward."""
    return sum(_layer_flops(cfg))
