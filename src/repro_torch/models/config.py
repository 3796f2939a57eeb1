"""Unified model configuration (port of `repro.models.config`).

One dataclass with the same fields as the reference's drives every model
family; the per-architecture files in `repro_torch.configs` instantiate
it. Two things differ from the reference:

- ``torch_dtype`` stands in for ``jnp_dtype``;
- ``attn_impl``/``ssm_impl`` take ``"kernel"`` (the hand-written CUDA
  kernels through `repro_torch.kernels.ops`, whose plain versions serve
  CPU tensors) or ``"plain"`` (the port of the reference's jnp paths),
  and default to ``"kernel"``, so the serving entry point runs the
  kernels on the card. `ModelConfig.from_dict` maps the reference's
  ``"pallas"``/``"jnp"`` onto them.

The port's own family ``granite`` (no counterpart in the reference) takes
its extra fields in the subclass `GraniteConfig`, which
`ModelConfig.from_dict` returns for ``family="granite"``; the fields of
every other family's config stay the reference's, key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch

__all__ = ["ModelConfig", "GraniteConfig", "IMPLS", "LAYER_TYPES"]

IMPLS = ("kernel", "plain")
# The reference's kernel-backend names and the port's.
_IMPL_OF_REFERENCE = {"pallas": "kernel", "jnp": "plain"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | granite
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # stablelm-2 partial rotary (0.25)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    sliding_window: Optional[int] = None  # mixtral SWA / rg local attention
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1
    moe_shard_axis: str = ""
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (recurrentgemma): groups of (attn_every - 1) recurrent layers
    # and one local-attention layer, then a recurrent tail.
    lru_width: int = 0
    attn_every: int = 0  # 3 => pattern [rec, rec, attn] (1:2)
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_positions: int = 0
    # frontends (stubs)
    modality: str = "text"  # text | audio_stub | vision_stub
    # numerics
    dtype: str = "bfloat16"
    # plain attention: blocked (online-softmax) above 1024 tokens
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    tie_embeddings: bool = False
    # activation checkpointing of the layers (training path only):
    #   none | full (recompute each layer from its input) | dots (keep the
    #   outputs of the matrix products, recompute the rest)
    remat: str = "none"
    # "kernel" (hand-written CUDA kernels) or "plain" (PyTorch paths)
    attn_impl: str = "kernel"
    ssm_impl: str = "kernel"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelConfig":
        """Build from a plain dict of the reference's fields, e.g.
        ``dataclasses.asdict(repro_cfg)``: ``"pallas"`` becomes
        ``"kernel"`` and ``"jnp"`` becomes ``"plain"``. A dict of family
        ``granite`` gives a `GraniteConfig`."""
        d = dict(d)
        if d.get("family") == "granite":
            cls = GraniteConfig
            d["layer_types"] = tuple(d.get("layer_types", ()))
            # the published configs name their position embedding; the
            # family runs without one (no rotary embedding)
            kind = d.pop("position_embedding_type", "nope")
            if kind != "nope":
                raise ValueError("the granite family runs without a position embedding "
                                 f"('nope'), got {kind!r}")
        for key in ("attn_impl", "ssm_impl"):
            if key in d:
                d[key] = _IMPL_OF_REFERENCE.get(d[key], d[key])
        if d.get("mrope_sections") is not None:
            d["mrope_sections"] = tuple(d["mrope_sections"])
        return cls(**d)

    # ---- derived ---------------------------------------------------------

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def validate(self) -> None:
        if self.attn_impl not in IMPLS or self.ssm_impl not in IMPLS:
            raise ValueError(
                f"attn_impl/ssm_impl must be one of {IMPLS}, got "
                f"{self.attn_impl!r}/{self.ssm_impl!r}"
            )
        if self.family in ("dense", "moe", "vlm", "audio"):
            assert self.n_heads > 0 and self.d_ff >= 0
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.family == "moe":
            assert 0 < self.experts_per_token <= self.n_experts
        if self.family == "ssm":
            assert self.ssm_state > 0 and self.ssm_heads > 0
        if self.family == "hybrid":
            assert self.attn_every > 1 and self.lru_width > 0
        if self.family == "audio":
            assert self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        if self.family == "ssm":
            di, ns, H = self.ssm_expand * D, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * ns
            per = (
                D * (2 * di + 2 * ns + H)
                + conv_dim * self.conv_width
                + di * D
                + di
                + 2 * H
                + D
            )
            return n + L * per
        hd, nh, nkv = self.d_head, self.n_heads, self.n_kv_heads
        attn = D * nh * hd + 2 * D * nkv * hd + nh * hd * D
        if self.qk_norm:
            attn += 2 * hd
        if self.mlp_act in ("swiglu", "geglu"):
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        norms = 2 * D
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * F + D * self.n_experts
        if self.family == "hybrid":
            n_attn = L // self.attn_every
            n_rec = L - n_attn
            W = self.lru_width
            rec = 2 * D * W + W * self.conv_width + W * D + 4 * W
            return n + n_attn * (attn + mlp + norms) + n_rec * (rec + mlp + norms) + D
        if self.family == "audio":
            enc = self.encoder_layers * (attn + 2 * D * F + norms)
            dec = L * (attn + attn + 2 * D * F + 3 * D)
            return n + enc + dec + self.encoder_positions * D
        return n + L * (attn + mlp + norms) + D


LAYER_TYPES = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class GraniteConfig(ModelConfig):
    """The ``granite`` family (IBM Granite 4.0 hybrids, HF
    ``granitemoehybrid`` without experts): Mamba-2 and attention mixers in
    the order of ``layer_types``, a SwiGLU MLP of ``d_ff`` after each, and
    the muP scalars of the published configs. The mixers' widths are the
    shared fields (``ssm_*``, ``conv_width``; ``n_heads``, ``n_kv_heads``,
    ``head_dim``)."""

    layer_types: Tuple[str, ...] = ()  # "mamba" | "attention", one per layer
    embedding_multiplier: float = 1.0  # the token embeddings are scaled by it
    residual_multiplier: float = 1.0  # each mixer's and MLP's output before its residual add
    attention_multiplier: float = 0.0  # softmax scale of the scores; set by every config
    logits_scaling: float = 1.0  # the logits are divided by it
    norm_eps: float = 1e-5  # every RMSNorm's epsilon

    def validate(self) -> None:
        super().validate()
        if len(self.layer_types) != self.n_layers or not set(self.layer_types) <= set(LAYER_TYPES):
            raise ValueError(f"layer_types must give one of {LAYER_TYPES} for each of "
                             f"{self.n_layers} layers, got {self.layer_types!r}")
        assert self.ssm_state > 0 and self.ssm_heads > 0 and self.d_ff > 0
        assert self.attention_multiplier > 0
        assert self.n_heads > 0 and self.n_heads % max(self.n_kv_heads, 1) == 0
        assert self.mlp_act == "swiglu" and self.norm == "rmsnorm"

    def param_count(self) -> int:
        """Every parameter the model holds: the embedding (and an untied
        head), the final norm, and per layer its two norms, its mixer and
        its MLP."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        di, N, H, W = self.ssm_expand * D, self.ssm_state, self.ssm_heads, self.conv_width
        conv_dim = di + 2 * N
        hd, nh, nkv = self.d_head, self.n_heads, self.n_kv_heads
        mamba = D * (2 * di + 2 * N + H) + (W + 1) * conv_dim + 3 * H + di + di * D
        attn = 2 * D * nh * hd + 2 * D * nkv * hd
        per = {"mamba": mamba, "attention": attn}
        n = V * D * (1 if self.tie_embeddings else 2) + D
        return n + sum(per[t] + 3 * D * F + 2 * D for t in self.layer_types)
