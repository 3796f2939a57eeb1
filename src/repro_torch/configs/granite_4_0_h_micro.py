"""IBM Granite 4.0-H Micro (3B) — 36 Mamba-2 and 4 NoPE attention mixers,
a SwiGLU MLP after each, muP scalars
(hf:ibm-granite/granite-4.0-h-micro, config.json: ``granitemoehybrid``
with no experts). The port's own arch: the reference has no granite
family."""

from repro_torch.models.config import GraniteConfig

_ATTENTION = (5, 15, 25, 35)  # config.json's layer_types

CONFIG = GraniteConfig(
    name="granite-4.0-h-micro",
    family="granite",
    n_layers=40,
    d_model=2048,
    vocab=100352,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,  # shared_intermediate_size
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    remat="full",
    layer_types=tuple("attention" if l in _ATTENTION else "mamba" for l in range(40)),
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
    norm_eps=1e-5,
)

# Two periods of (mamba, attention) at CPU size; the scalars as published.
SMOKE = GraniteConfig(
    name="granite-smoke",
    family="granite",
    n_layers=4,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,  # the published head size, the smallest K3 takes
    d_ff=256,
    ssm_state=16,
    ssm_heads=8,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=32,
    conv_width=4,
    tie_embeddings=True,
    dtype="float32",
    layer_types=("mamba", "attention", "mamba", "attention"),
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=1.0 / 64,
    logits_scaling=8.0,
    norm_eps=1e-5,
)
