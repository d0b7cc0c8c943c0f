"""qwen3-moe 235B-A22B [hf:Qwen/Qwen3-30B-A3B family scaling].

94 layers, 128 experts top-8, per-expert d_ff 1536, GQA 64 q heads /
4 kv heads at head_dim 128.  Every layer is MoE; expert parallelism
shards the 128 experts over the 16-way model axis (8 per device) — the
paper's kernel-sharding with experts as the kernel sets.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # per-expert hidden dim
    vocab_size=151936,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8, expert_d_ff=1536),
    source="hf:Qwen/Qwen3-30B-A3B",
)
