"""Qwen2-VL 72B — VLM backbone, M-RoPE, dynamic resolution (vision stub)
[arXiv:2409.12191]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2
    rope_theta=1e6,
    modality="vision_stub",
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    mrope_sections=(4, 6, 6),
    modality="vision_stub",
    dtype="float32",
)
