"""nemotron-4-340b [arXiv:2402.16819].

96 layers at d_model 18432, GQA 96/8 (head_dim 192), squared-ReLU
non-gated MLP with d_ff 73728, vocab 256000.  The scale forces the
beyond-paper memory regime: FSDP over pod/data + TP over model, Adafactor
(factored second moments), full remat, grad accumulation — see DESIGN.md
§4 and the dry-run memory analysis.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    gated_mlp=False,
    norm="layernorm",
    source="arXiv:2402.16819",
)
