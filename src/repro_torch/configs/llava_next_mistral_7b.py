"""llava-next (v1.6) mistral-7b backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: mistral-7B language model + anyres tiling vision frontend.  The
SigLIP/CLIP vision tower is a STUB per the assignment carve-out —
input_specs() provides (B, 2880, 1024) patch embeddings (5 anyres tiles x
576 patches); the 2-layer MLP projector and the full LM backbone are real.
Mistral's native sliding-window attention (4096) makes long_500k runnable.
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    vision=VisionStubConfig(vision_dim=1024, num_image_tokens=2880,
                            projector_hidden=4096),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
