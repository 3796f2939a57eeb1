"""Granite 4.0 hybrid language model: Mamba-2 and NoPE attention mixers,
each followed by a SwiGLU MLP (HF ``granitemoehybrid`` with no experts,
hf:ibm-granite/granite-4.0-h-micro). The family is the port's own; the
JAX package has no counterpart.

Layer l (pre-norm, the muP scalars of the config)::

    h = embedding_multiplier * E[tokens]
    h = h + residual_multiplier * mixer_l(RMSNorm(h))
    h = h + residual_multiplier * W_down(SiLU(x W_gate) * (x W_up)),  x = RMSNorm(h)
    logits = RMSNorm(h) E^T / logits_scaling        (tied embedding)

``mixer_l`` is ``layer_types[l]``:

- ``"mamba"``: `mamba2.ssm_mixer` with the gate before the norm,
  out_proj(RMSNorm(y * SiLU(z))) over all d_inner channels, so its SSD runs
  through K4 (``ops.ssd_scan``) as mamba2's does;
- ``"attention"``: causal grouped-query attention with no position
  embedding, scores scaled by ``attention_multiplier``, through K3
  (``ops.flash_attention``, forward and backward kernels). K3 scales by
  1 / sqrt(head_dim), so q is multiplied by attention_multiplier *
  sqrt(head_dim) first (1/64 * 8 = 1/8 for granite-4.0-h-micro: a power
  of two, exact in bf16).

Every RMSNorm takes ``norm_eps`` and the port's ``(1 + w)`` scale. The
logits' division is applied to the final hidden state before the head: for
a power of two (8 here) the same bits, without a (B, S, V) copy.

Entry points as the other families': ``forward(tokens)`` (hidden after
the final norm), ``loss(batch)``, ``init_cache(B, seq_len)``,
``prefill(tokens, extra_slots=0)``, ``decode_step(cache, token)``. Each
layer runs under ``maybe_remat``; ``ssm_mixer``, ``attn_mixer`` and
``mlp`` are looked up in this module at call time (a profiler may wrap
them) and mark the spans ``granite.ssm_mixer``, ``granite.attn_mixer``
and ``granite.mlp`` while a profiler records, on the forward pass and on
remat's recompute.

Cache, two kinds of state side by side: the Mamba layers' ``ssm`` (Lm, B,
H, P, N) float32 and ``conv`` (Lm, B, W - 1, conv_dim) pre-conv tail, the
attention layers' ``k``/``v`` (La, B, C, KV, hd) with C = prompt +
``extra_slots`` (no window, no rotation), and ``len`` a Python int; Lm and
La count the layers of each kind in order. ``decode_step`` writes the
cache's tensors in place.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.tracing import span

from . import mamba2
from .config import GraniteConfig
from .layers import (
    ParamModule,
    _const,
    _normal,
    decode_attention,
    maybe_remat,
    mlp_apply,
    rmsnorm,
)
from .losses import lm_loss
from .transformer import attend

__all__ = ["GraniteBlock", "Granite", "ssm_mixer", "attn_mixer", "mlp"]


class GraniteBlock(ParamModule):
    """One layer: ``ln`` and ``ln2`` (the norms before the mixer and the
    MLP), the mixer's parameters (mamba2's names for a Mamba layer; ``wq``,
    ``wk``, ``wv``, ``wo`` for attention) and the MLP's ``w_gate``,
    ``w_up``, ``w_down``."""

    def __init__(self, cfg: GraniteConfig, kind: str, device) -> None:
        dt = cfg.torch_dtype
        D, L, F = cfg.d_model, cfg.n_layers, cfg.d_ff
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        out_scale = 0.02 / max(L, 1) ** 0.5
        spec = {"ln": _const((D,), 0.0, dt)}
        if kind == "mamba":
            spec.update(mamba2.mixer_spec(cfg))
        else:
            spec.update({
                "wq": _normal((D, H * hd), 0.02, dt),
                "wk": _normal((D, KV * hd), 0.02, dt),
                "wv": _normal((D, KV * hd), 0.02, dt),
                "wo": _normal((H * hd, D), out_scale, dt),
            })
        spec.update({
            "ln2": _const((D,), 0.0, dt),
            "w_gate": _normal((D, F), 0.02, dt),
            "w_up": _normal((D, F), 0.02, dt),
            "w_down": _normal((F, D), out_scale, dt),
        })
        super().__init__(spec, device)
        self.kind = kind

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "GraniteBlock":
        super().init_(generator)
        if self.kind == "mamba":
            mamba2.init_A_log(self.A_log)
        return self


# ---- the three sub-blocks (normed input, no residual) ------------------------


def ssm_mixer(cfg: GraniteConfig, lp, h: torch.Tensor) -> torch.Tensor:
    with span("granite.ssm_mixer"):
        return mamba2.ssm_mixer(cfg, lp, h, norm_before_gate=False, eps=cfg.norm_eps)


def _qkv(cfg: GraniteConfig, lp, h: torch.Tensor):
    """q (scaled for K3's 1 / sqrt(hd), see the module's docstring), k, v."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (h @ lp.wq).reshape(B, S, H, hd) * (cfg.attention_multiplier * math.sqrt(hd))
    k = (h @ lp.wk).reshape(B, S, KV, hd)
    v = (h @ lp.wv).reshape(B, S, KV, hd)
    return q, k, v


def attn_mixer(cfg: GraniteConfig, lp, h: torch.Tensor) -> torch.Tensor:
    with span("granite.attn_mixer"):
        B, S, _ = h.shape
        o = attend(cfg, *_qkv(cfg, lp, h))
        return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp.wo


def mlp(cfg: GraniteConfig, lp, h: torch.Tensor) -> torch.Tensor:
    with span("granite.mlp"):
        return mlp_apply(h, lp, "swiglu")


def _layer_seq(cfg: GraniteConfig, lp, x: torch.Tensor) -> torch.Tensor:
    """One layer on a full sequence, the training path."""
    r = cfg.residual_multiplier
    mixer = ssm_mixer if lp.kind == "mamba" else attn_mixer
    x = x + mixer(cfg, lp, rmsnorm(x, lp.ln, cfg.norm_eps)) * r
    return x + mlp(cfg, lp, rmsnorm(x, lp.ln2, cfg.norm_eps)) * r


class Granite(ParamModule):
    """The hybrid LM. Its own parameters are the embedding, the final norm
    and an untied head; ``layers`` holds the blocks in ``layer_types``'
    order."""

    def __init__(self, cfg: GraniteConfig, device="cuda") -> None:
        cfg.validate()
        dt = cfg.torch_dtype
        D, V = cfg.d_model, cfg.vocab
        spec = {"embed": _normal((V, D), 0.02, dt), "final_norm": _const((D,), 0.0, dt)}
        if not cfg.tie_embeddings:
            spec["lm_head"] = _normal((D, V), 0.02, dt)
        super().__init__(spec, device)
        self.cfg = cfg
        kinds = cfg.layer_types
        self.layers = nn.ModuleList(GraniteBlock(cfg, t, device) for t in kinds)
        # each layer's index in the cache among the layers of its kind
        self.slots = [kinds[:l].count(t) for l, t in enumerate(kinds)]

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Granite":
        super().init_(generator)
        for blk in self.layers:
            blk.init_(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()] * self.cfg.embedding_multiplier

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (hidden / self.cfg.logits_scaling) @ head

    # ---- training -----------------------------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Hidden states (B, S, D) after the final norm."""
        cfg = self.cfg
        x = self._embed(tokens)
        for lp in self.layers:
            x = maybe_remat(lambda u, lp=lp: _layer_seq(cfg, lp, u), cfg.remat)(x)
        return self._final(x)

    def loss(self, batch: dict) -> Tuple[torch.Tensor, dict]:
        """Mean token NLL (row-weighted when the batch has
        ``loss_weights``); returns (loss, {"nll", "moe_aux"})."""
        logits = self._logits(self.forward(batch["tokens"]))
        loss = lm_loss(logits, batch["labels"], batch.get("loss_weights"))
        return loss, {"nll": loss, "moe_aux": torch.zeros((), dtype=torch.float32, device=loss.device)}

    # ---- serving ------------------------------------------------------------

    def init_cache(self, B: int, seq_len: int) -> dict:
        cfg = self.cfg
        di, H, P, N, conv_dim = mamba2._dims(cfg)
        Lm, La = cfg.layer_types.count("mamba"), cfg.layer_types.count("attention")
        dt, dev = cfg.torch_dtype, self.device
        kv = (La, B, seq_len, cfg.n_kv_heads, cfg.d_head)
        return {
            "ssm": torch.zeros((Lm, B, H, P, N), dtype=torch.float32, device=dev),
            "conv": torch.zeros((Lm, B, cfg.conv_width - 1, conv_dim), dtype=dt, device=dev),
            "k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev),
            "len": 0,
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, extra_slots: int = 0) -> Tuple[torch.Tensor, dict]:
        """Prompt pass (B, S): the last position's logits (B, 1, V) and the
        cache, with ``extra_slots`` KV slots of decode headroom."""
        cfg = self.cfg
        B, S = tokens.shape
        r, eps = cfg.residual_multiplier, cfg.norm_eps
        x = self._embed(tokens)
        cache = self.init_cache(B, S + extra_slots)
        for lp, i in zip(self.layers, self.slots):
            h = rmsnorm(x, lp.ln, eps)
            if lp.kind == "mamba":
                y, cache["ssm"][i], cache["conv"][i] = mamba2.ssm_mixer_prefill(
                    cfg, lp, h, norm_before_gate=False, eps=eps)
            else:
                q, k, v = _qkv(cfg, lp, h)
                cache["k"][i, :, :S] = k
                cache["v"][i, :, :S] = v
                y = attend(cfg, q, k, v).reshape(B, S, -1) @ lp.wo
            x = x + y * r
            x = x + mlp(cfg, lp, rmsnorm(x, lp.ln2, eps)) * r
        cache["len"] = S
        return self._logits(self._final(x[:, -1:])), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step (token (B, 1)); updates the cache in place.
        Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        B = token.shape[0]
        r, eps = cfg.residual_multiplier, cfg.norm_eps
        n = cache["len"]
        C = cache["k"].shape[2]
        if n >= C:
            raise ValueError(f"the KV cache holds {C} positions; prefill with extra_slots")
        valid = (torch.arange(C, device=token.device) <= n)[None].expand(B, C)
        x = self._embed(token)
        for lp, i in zip(self.layers, self.slots):
            h = rmsnorm(x, lp.ln, eps)
            if lp.kind == "mamba":
                y, cache["ssm"][i], cache["conv"][i] = mamba2.ssm_mixer_step(
                    cfg, lp, h, cache["ssm"][i], cache["conv"][i], norm_before_gate=False,
                    eps=eps)
            else:
                q, k, v = _qkv(cfg, lp, h)
                cache["k"][i, :, n] = k[:, 0]
                cache["v"][i, :, n] = v[:, 0]
                o = decode_attention(q, cache["k"][i], cache["v"][i], valid)
                y = o.reshape(B, 1, -1) @ lp.wo
            x = x + y * r
            x = x + mlp(cfg, lp, rmsnorm(x, lp.ln2, eps)) * r
        cache["len"] = n + 1
        return self._logits(self._final(x)), cache
