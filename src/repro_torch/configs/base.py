"""Config dataclasses of the port: model architecture and run settings.

Counterpart of ``repro/configs/base.py``, with the same fields and
defaults.  ``ModelConfig.compute_dtype`` is a torch dtype.  The input
shapes of the dry runs (``InputShape``, ``INPUT_SHAPES``) are the JAX
package's.  ``ConvChainConfig`` (with ``ChainConv`` and ``ChainDense``)
is the port's own: a CNN of any depth for the cluster's training path,
such as VGG-16 (``configs/vgg16.py``); ``ResNetConfig`` (with
``BottleneckStage``) is a residual network of bottleneck blocks for the
same path, such as ResNet-50 (``configs/resnet50.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    expert_d_ff: int
    # router
    router_jitter: float = 0.0
    load_balance_loss_weight: float = 0.01
    # capacity factor for dropped-token dispatch path (dense path ignores it)
    capacity_factor: float = 1.25
    # combine schedule: "psum" (tokens replicated, expert outputs summed)
    # or "alltoall" (capacity buffers exchanged with two all-to-alls)
    dispatch: str = "psum"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """Modality frontend stub (VLM): patch embeddings come from the caller."""

    vision_dim: int = 1024
    num_image_tokens: int = 2880  # llava-next anyres: 5 tiles x 576 patches
    projector_hidden: int = 4096


@dataclasses.dataclass(frozen=True)
class AudioStubConfig:
    """Modality frontend stub (audio): frame embeddings as the conv
    frontend emits them (mel 3000 frames -> stride-2 conv -> 1500)."""

    num_frames: int = 1500
    frame_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    activation: str = "silu"  # silu | gelu | squared_relu
    gated_mlp: bool = True
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # SWA width; None = full attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionStubConfig] = None
    audio: Optional[AudioStubConfig] = None
    num_encoder_layers: int = 0  # >0 => encoder-decoder
    logit_softcap: Optional[float] = None
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # source citation (from the public pool assignment)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode path exists (SSM state or sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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


@dataclasses.dataclass(frozen=True)
class ChainConv:
    """One conv layer of a ``ConvChainConfig``: ``kernels`` output
    channels of ``kernel_size`` x ``kernel_size`` (SAME, stride 1), then
    its stage: +bias, ReLU, cross-channel LRN if ``lrn``, a max-pool
    (window and stride the chain's ``pool_stride``) if ``pool``.  Its
    params are ``name`` -> ``kernel`` (HWIO), ``bias``."""

    name: str
    kernels: int
    kernel_size: int = 3
    lrn: bool = False
    pool: bool = False


@dataclasses.dataclass(frozen=True)
class ChainDense:
    """One dense layer of a ``ConvChainConfig``'s head: ``units``
    outputs, then ReLU if ``relu``, then inverted dropout at ``dropout``
    (kept units scaled by 1 / (1 - dropout)) if it is above 0.  Its
    params are ``name`` -> ``kernel`` (in, out), ``bias``."""

    name: str
    units: int
    relu: bool = False
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class ConvChainConfig:
    """A CNN as a chain of conv layers, each with its own stage, and a
    head of dense layers ending in softmax cross-entropy over the last
    one's units.  Activations NHWC; the head flattens the last stage's
    output in H, W, C order."""

    arch_id: str
    convs: Tuple[ChainConv, ...]
    dense: Tuple[ChainDense, ...]
    image_size: int
    image_channels: int = 3
    pool_stride: int = 2
    dtype: str = "float32"
    family: str = "cnn"

    @property
    def num_classes(self) -> int:
        return self.dense[-1].units


@dataclasses.dataclass(frozen=True)
class BottleneckStage:
    """One stage of a ``ResNetConfig``: ``blocks`` bottleneck blocks,
    each [1x1, ``width``; 3x3, ``width``; 1x1, expansion x ``width``]
    convs, each conv followed by batch norm, ReLU after the first two
    and after the block's residual add.  The stage's first block has
    stride ``stride`` on its first 1x1 and on its projection."""

    width: int
    blocks: int
    stride: int = 1


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """A residual network of bottleneck blocks (He et al.,
    arXiv:1512.03385): a stem conv of ``stem_kernel`` x ``stem_kernel``
    with ``stem_width`` kernels, stride 2 and padding ``stem_kernel //
    2``, batch norm, ReLU and a 3x3/2 max-pool with padding 1; the
    ``stages``; a global average pool; a dense layer of ``num_classes``
    units and softmax cross-entropy.  A block's shortcut is the identity,
    or a projection (a 1x1 conv and batch norm, option B) where the
    width or the stride changes.  The convs have no bias; batch norm
    takes train-mode statistics with ``bn_eps``.  Activations NHWC."""

    arch_id: str
    stages: Tuple[BottleneckStage, ...]
    image_size: int = 224
    image_channels: int = 3
    stem_width: int = 64
    stem_kernel: int = 7
    expansion: int = 4
    num_classes: int = 1000
    bn_eps: float = 1e-5
    dtype: str = "float32"
    family: str = "cnn"


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Distribution / training-loop knobs, orthogonal to the architecture."""

    tp_mode: str = "megatron"  # gather (paper-faithful) | megatron (optimised)
    fsdp: bool = True
    remat: str = "full"  # none | full | dots
    grad_accum: int = 1  # microbatch count
    optimizer: str = "adam"  # sgd | adam | adafactor
    learning_rate: float = 3e-4
    schedule: str = "cosine"  # constant | cosine | wsd
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    seed: int = 0

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests
    (2 layers, d_model<=512, <=4 experts)."""
    d_model = min(cfg.d_model, 256)
    # keep head structure valid (attention-free archs keep 0 heads)
    if cfg.num_heads > 0:
        num_heads = min(cfg.num_heads, 4)
        num_kv_heads = max(1, min(cfg.num_kv_heads, num_heads))
        while num_heads % num_kv_heads:
            num_kv_heads -= 1
        head_dim = max(8, d_model // num_heads)
    else:
        num_heads = num_kv_heads = 0
        head_dim = 32
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, 4),
            experts_per_token=min(moe.experts_per_token, 2),
            expert_d_ff=min(moe.expert_d_ff, 128),
        )
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(
            ssm, d_state=min(ssm.d_state, 16), head_dim=32, chunk_size=32
        )
    vision = cfg.vision
    if vision is not None:
        vision = dataclasses.replace(
            vision, vision_dim=64, num_image_tokens=8, projector_hidden=64
        )
    audio = cfg.audio
    if audio is not None:
        audio = dataclasses.replace(audio, num_frames=16, frame_dim=d_model)
    return cfg.with_(
        num_layers=2,
        num_encoder_layers=2 if cfg.num_encoder_layers else 0,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) or cfg.d_ff,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else None,
        moe=moe,
        ssm=ssm,
        vision=vision,
        audio=audio,
        dtype="float32",
        param_dtype="float32",
    )
