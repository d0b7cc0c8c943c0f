"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality).

Attention-free: 48 pure mamba2 blocks, d_model 1024, d_state 128,
head_dim 64 (expand 2 -> d_inner 2048 -> 32 SSD heads).  The paper's
technique has no attention axis here; the SSD *head* axis is the
output-feature analogue sharded over `model` (DESIGN.md
§Arch-applicability).  O(1) recurrent state -> long_500k native.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    source="arXiv:2405.21060",
)
