"""Mamba-2 1.3B — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    vocab=512,
    ssm_state=16,
    ssm_heads=8,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=32,
    conv_width=4,
    tie_embeddings=True,
    dtype="float32",
)
