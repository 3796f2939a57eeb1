"""InternLM2 20B — dense, GQA [arXiv:2403.17297]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    rope_theta=1e6,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    n_layers=2,
    d_model=192,
    n_heads=6,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab=512,
    dtype="float32",
)
