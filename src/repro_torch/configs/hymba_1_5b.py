"""hymba-1.5b [arXiv:2411.13676].

Hybrid-head architecture: every block runs attention heads and mamba
(SSM) heads IN PARALLEL on the same input and fuses the outputs — here by
averaging after each branch (the paper uses learned per-branch output
norms; averaging is the fusion the smoke oracle checks).  25 query heads /
5 kv heads at head_dim 64; sliding-window attention (1024) in the global
config makes long_500k runnable together with the O(1) SSM state.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    sliding_window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    source="arXiv:2411.13676",
)
