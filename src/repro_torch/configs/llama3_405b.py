"""Llama-3.1 405B — dense, GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab=512,
    rope_theta=5e5,
    dtype="float32",
)
