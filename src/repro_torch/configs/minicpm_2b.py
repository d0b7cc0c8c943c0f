"""minicpm-2b [arXiv:2404.06395].

Llama-like dense arch with MHA (36 heads = 36 kv heads, head_dim 64),
tied embeddings, trained with the WSD schedule (optim/schedule.py; the
train launcher selects schedule="wsd" for this arch).  Full attention,
no sub-quadratic variant -> long_500k skipped (DESIGN.md policy).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2404.06395",
)
