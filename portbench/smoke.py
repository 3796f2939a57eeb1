"""Cells of BENCHMARK.json at a size the CPU tests can hold: the same
runtime, mix and comparison, with each family's model cut to a few
hundred thousand parameters and the mix to short rows. Tests only."""

from __future__ import annotations

import copy

__all__ = ["MODELS", "smoke_cell"]

MODELS = {
    "ssm": dict(family="ssm", n_layers=2, d_model=128, vocab=512, ssm_state=16, ssm_heads=8,
                ssm_head_dim=32, ssm_expand=2, ssm_chunk=32, conv_width=4,
                tie_embeddings=True, dtype="float32", remat="full"),
    "moe": dict(family="moe", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                d_ff=128, vocab=512, n_experts=4, experts_per_token=2, capacity_factor=1.25,
                router_aux_weight=0.01, moe_groups=1, rope_theta=10000.0, mlp_act="swiglu",
                norm="rmsnorm", tie_embeddings=False, dtype="float32", remat="full"),
}


def smoke_cell(name: str, dtype: str = "float32", limits=None, spec=None):
    """Cell ``name`` (of ``spec``, BENCHMARK.json's when None) with its
    family's small model in ``dtype``, rows of 64 tokens (4 rows a step for
    a plain mix) and ``limits`` (the cell's own when None)."""
    from portbench import harness

    full = harness.resolve(name, spec)
    config = copy.deepcopy(full.config)
    config["model"] = dict(MODELS[config["model"]["family"]], dtype=dtype)
    traffic = dict(full.traffic, seq=64)
    if "rows" in traffic:
        traffic["rows"] = 4
    return harness.resolve(name, spec, config=config, traffic=traffic,
                           limits=full.limits if limits is None else limits)
