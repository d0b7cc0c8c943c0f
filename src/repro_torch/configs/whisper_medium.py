"""whisper-medium transformer backbone [arXiv:2212.04356].

Encoder-decoder; the mel-spectrogram + conv1d frontend is a STUB per the
assignment carve-out — input_specs() provides (B, 1500, 1024) frame
embeddings as the stride-2 conv stack emits them.  LayerNorm + GELU
(non-gated) per the paper; decoder embedding tied with the logits head.
RoPE replaces whisper's learned absolute positions (DESIGN.md backbone
adaptation note).
"""
from repro_torch.configs.base import AudioStubConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="encdec",
    num_layers=24,           # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,         # MHA
    d_ff=4096,
    vocab_size=51865,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    tie_embeddings=True,
    audio=AudioStubConfig(num_frames=1500, frame_dim=1024),
    source="arXiv:2212.04356",
)
