"""mixtral-8x22b [arXiv:2401.04088].

56 layers, 8 experts top-2 with per-expert d_ff 16384, GQA 48/8
(head_dim 128), sliding-window attention per the pool assignment ->
long_500k runnable.  8 experts < 16-way model axis, so the MoE layer
shards each expert's d_ff instead (per-expert tensor parallelism) — the
same psum-combine code path (layers/moe.py).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,              # per-expert hidden dim
    vocab_size=32768,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=16384),
    source="arXiv:2401.04088",
)
