"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    experts_per_token=2,
    rope_theta=1e4,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="phi35-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab=512,
    n_experts=4,
    experts_per_token=2,
    capacity_factor=8.0,
    dtype="float32",
)
