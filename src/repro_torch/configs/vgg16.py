"""VGG-16: configuration D of Simonyan & Zisserman, "Very Deep
Convolutional Networks for Large-Scale Image Recognition"
(arXiv:1409.1556, Table 1), as a ``ConvChainConfig``:

    13 convs 3x3 (SAME, stride 1), each + bias and ReLU, in blocks of
    64, 64 | 128, 128 | 256 x 3 | 512 x 3 | 512 x 3 kernels, a 2x2/2
    max-pool after each block;
    fc6 25088 -> 4096 and fc7 4096 -> 4096, each + ReLU and dropout 0.5;
    fc8 4096 -> 1000, softmax.

224x224x3 inputs, float32, 138,357,544 parameters.  No LRN (the paper
drops it from the deeper configurations).
"""
from repro_torch.configs.base import ChainConv, ChainDense, ConvChainConfig

# SGD's rate for VGG-16: the paper's initial one (3.1)
SGD_LR = 0.01

BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


def make_vgg16_config(width_divisor: int = 1, image_size: int = 224) -> ConvChainConfig:
    """VGG-16 with every conv width and fc6/fc7's units divided by
    ``width_divisor`` on ``image_size`` inputs (a multiple of 32); the
    1000 classes, the topology and the dropout as published.  The
    defaults are the published network."""
    convs = tuple(
        ChainConv(f"conv{b}_{i}", width // width_divisor, 3, pool=i == len(block))
        for b, block in enumerate(BLOCKS, 1)
        for i, width in enumerate(block, 1)
    )
    fc = 4096 // width_divisor
    dense = (ChainDense("fc6", fc, relu=True, dropout=0.5),
             ChainDense("fc7", fc, relu=True, dropout=0.5),
             ChainDense("fc8", 1000))
    arch_id = "vgg16" if (width_divisor, image_size) == (1, 224) else (
        f"vgg16_w{width_divisor}_s{image_size}")
    return ConvChainConfig(arch_id=arch_id, convs=convs, dense=dense, image_size=image_size)


CONFIG = make_vgg16_config()
