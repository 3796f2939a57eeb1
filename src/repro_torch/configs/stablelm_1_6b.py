"""StableLM 2 1.6B — dense, MHA (kv=32), partial rotary (25%), LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    rope_fraction=0.25,
    norm="layernorm",
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    rope_fraction=0.25,
    norm="layernorm",
    dtype="float32",
)
