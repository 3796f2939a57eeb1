"""Whisper medium — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder layers
    encoder_layers=24,
    encoder_positions=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    mlp_act="gelu",
    modality="audio_stub",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    encoder_layers=2,
    encoder_positions=64,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    norm="layernorm",
    mlp_act="gelu",
    modality="audio_stub",
    tie_embeddings=True,
    dtype="float32",
)
