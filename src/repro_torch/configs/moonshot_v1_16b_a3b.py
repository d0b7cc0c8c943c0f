"""moonshot-v1 16B-A3B (Moonlight) [hf:moonshotai/Moonlight-16B-A3B].

The pool tags this [dense] but specifies "MoE 64e top-6" — we implement
the MoE per the numbers (DESIGN.md §Arch-applicability note): 48 layers,
64 experts top-6 with per-expert d_ff 1408, MHA 16 heads (kv=16).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,               # per-expert hidden dim
    vocab_size=163840,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=64, experts_per_token=6, expert_d_ff=1408),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
