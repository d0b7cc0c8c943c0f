"""ResNet-50: the 50-layer network of He et al., "Deep Residual
Learning for Image Recognition" (arXiv:1512.03385, Table 1), as a
``ResNetConfig``:

    conv1 7x7, 64, stride 2 -> BN -> ReLU -> max-pool 3x3/2;
    conv2_x .. conv5_x: 3, 4, 6 and 3 bottleneck blocks [1x1, C; 3x3,
    C; 1x1, 4C] with C = 64, 128, 256, 512, BN after every conv; an
    identity shortcut, or a projection (1x1 conv + BN, option B) where
    the width or the stride changes; stride 2 in conv3_1, conv4_1 and
    conv5_1;
    global average pool -> fc 2048 -> 1000, softmax.

224x224x3 inputs, float32, 25,557,032 parameters, 3.86 G multiply-adds
a forward.  The stride lies on a block's first 1x1 and on its
projection, as in the authors' released Caffe model
(github.com/KaimingHe/deep-residual-networks), which gives Table 1's
3.8 G multiply-adds (torchvision's "v1.5" moves it to the 3x3).
"""
from repro_torch.configs.base import BottleneckStage, ResNetConfig

# SGD's rate: He et al.'s 0.1 at batch 256, scaled linearly to batch 128
SGD_LR = 0.05

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def make_resnet50_config(width_divisor: int = 1, image_size: int = 224) -> ResNetConfig:
    """ResNet-50 with the stem's and every stage's width divided by
    ``width_divisor`` on ``image_size`` inputs (a multiple of 32); the
    depth, the strides and the 1000 classes as published.  The defaults
    are the published network."""
    stages = tuple(BottleneckStage(width // width_divisor, blocks, stride)
                   for width, blocks, stride in STAGES)
    arch_id = "resnet50" if (width_divisor, image_size) == (1, 224) else (
        f"resnet50_w{width_divisor}_s{image_size}")
    return ResNetConfig(arch_id=arch_id, stages=stages, image_size=image_size,
                        stem_width=64 // width_divisor)


CONFIG = make_resnet50_config()
