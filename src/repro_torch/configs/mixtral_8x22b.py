"""Mixtral 8x22B — MoE, 8 experts top-2, GQA, SWA [arXiv:2401.04088]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,  # assignment lists SWA for this entry
    rope_theta=1e6,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    n_experts=4,
    experts_per_token=2,
    capacity_factor=8.0,
    sliding_window=64,
    dtype="float32",
)
