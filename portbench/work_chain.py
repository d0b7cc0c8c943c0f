"""The operations one SGD step of a chain CNN requires, from the
configuration file's shapes: every conv's forward and dW, its dX but
the first conv's (the images need none), and each dense layer's three
products (forward, dX, dW).  fp32's peak is ``work.py``'s.

A configuration with ``blocks`` and ``dense`` (VGG-16) is such a chain
as it stands; the paper's CIFAR net (``c1_kernels``, ``c2_kernels``)
is the chain of two one-conv blocks and a ``num_classes`` fc, so its
count equals ``work.train_step_flops``.
"""
from __future__ import annotations


def blocks(cfg: dict) -> list:
    """The conv widths, block by block; a pool ends each block."""
    return cfg.get("blocks") or [[cfg["c1_kernels"]], [cfg["c2_kernels"]]]


def conv_layers(cfg: dict) -> list:
    """(H, Cin, Cout, k) of each conv in order."""
    h, cin, k, out = cfg["image_size"], cfg["image_channels"], cfg["kernel_size"], []
    for block in blocks(cfg):
        for cout in block:
            out.append((h, cin, cout, k))
            cin = cout
        h //= cfg["pool_stride"]
    return out


def head_inputs(cfg: dict) -> int:
    """The features the first dense layer takes: the last pool's output."""
    b = blocks(cfg)
    h = cfg["image_size"] // cfg["pool_stride"] ** len(b)
    return h * h * b[-1][-1]


def train_step_flops(cfg: dict, batch: int) -> float:
    """Operations one SGD step of ``batch`` images requires (2 a
    multiply-add)."""
    total = 0.0
    for i, (h, cin, cout, k) in enumerate(conv_layers(cfg)):
        total += (2 if i == 0 else 3) * 2.0 * h * h * k * k * cin * cout
    n_in = head_inputs(cfg)
    for units in cfg.get("dense") or [cfg["num_classes"]]:
        total += 3 * 2.0 * n_in * units
        n_in = units
    return batch * total
