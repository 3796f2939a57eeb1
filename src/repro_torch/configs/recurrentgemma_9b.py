"""RecurrentGemma 9B — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    lru_width=4096,
    attn_every=3,  # [rec, rec, attn] — the paper's 1:2 ratio
    sliding_window=2048,  # local attention window
    mlp_act="geglu",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=3,  # one full [rec, rec, attn] group
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab=512,
    lru_width=128,
    attn_every=3,
    sliding_window=64,
    mlp_act="geglu",
    dtype="float32",
)
