"""The operations one SGD step of a residual network of bottleneck
blocks (ResNet-50) requires, from the configuration file's shapes, at
the published strides: every conv's forward and dW (conv1 at its
stride-2 outputs), dX of every conv but conv1 (the images need none),
and the fc layer's three products (forward, dX, dW).  fp32's peak is
``work.py``'s.  The program runs conv1 at stride 1 and subsamples, 4x
conv1's forward and dW: work the count leaves out."""
from __future__ import annotations


def conv_layers(cfg: dict) -> list:
    """(output H, k, Cin, Cout) of each conv at its published stride:
    conv1, then per block its projection (where the width or the stride
    changes), 1x1, 3x3 and 1x1."""
    h = -(-cfg["image_size"] // cfg["stem_stride"])
    out = [(h, cfg["stem_kernel"], cfg["image_channels"], cfg["stem_width"])]
    pool = cfg["stem_pool"]
    h = (h + 2 * pool["padding"] - pool["window"]) // pool["stride"] + 1
    cin = cfg["stem_width"]
    for stage in cfg["stages"]:
        width, cout = stage["width"], cfg["expansion"] * stage["width"]
        for j in range(stage["blocks"]):
            stride = stage["stride"] if j == 0 else 1
            h_out = -(-h // stride)
            if stride != 1 or cin != cout:
                out.append((h_out, 1, cin, cout))
            out += [(h_out, 1, cin, width), (h_out, 3, width, width), (h_out, 1, width, cout)]
            h, cin = h_out, cout
    return out


def image_flops(cfg: dict) -> float:
    """Operations one image's step requires (2 a multiply-add)."""
    total = 0.0
    for i, (h, k, cin, cout) in enumerate(conv_layers(cfg)):
        total += (2 if i == 0 else 3) * 2.0 * h * h * k * k * cin * cout
    width = cfg["expansion"] * cfg["stages"][-1]["width"]
    return total + 3 * 2.0 * width * cfg["num_classes"]


def train_step_flops(cfg: dict, batch: int) -> float:
    return batch * image_flops(cfg)
