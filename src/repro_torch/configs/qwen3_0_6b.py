"""Qwen3 0.6B — dense, qk-norm, GQA [hf:Qwen/Qwen3-0.6B family card]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    qk_norm=True,
    tie_embeddings=True,
    dtype="float32",
)
