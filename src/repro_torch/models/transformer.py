"""Decoder-only transformer LM covering the dense, MoE and VLM-backbone
configs (port of `repro.models.transformer`).

Trains and serves qwen3-0.6b, llama3-405b, stablelm-1.6b, internlm2-20b
(dense), phi3.5-moe and mixtral-8x22b (MoE) and qwen2-vl-72b (the VLM
backbone with its vision stub): ``Transformer`` is an ``nn.Module`` whose
``layers`` is an ``nn.ModuleList`` of per-layer ``DenseBlock``s, with

  forward(tokens, extra_embeds=None) -> (hidden (B, S, D), moe_aux)
  loss(batch)     -> (loss, metrics)               the reference's loss_fn
  prefill(tokens, extra_embeds=None, extra_slots=0)
                  -> (logits of the last position, cache)
  decode_step(cache, token)       -> (logits, cache)
  init_cache(B, seq_len)          -> cache

Weights keep the reference's names and ``(in, out)`` orientation
(``x @ W``), so `repro_torch.models.params.from_reference` loads a layer
as a slice of the reference's stacked arrays. Full-sequence attention
(training and prefill) goes through the flash-attention kernel
(``attn_impl="kernel"``; differentiable on the card through its backward
kernel) or the plain path (``"plain"``: full-matrix, or blocked above
1024 tokens, as in the reference); decode is plain. ``forward`` runs each
layer under ``maybe_remat``.

An MoE layer's FFN is `layers.moe_apply` (token-choice top-k with
per-expert capacity) over the layer's tokens; ``forward`` sums its aux
loss over the layers and ``loss`` adds ``router_aux_weight`` times it.
Decode routes its B tokens as one batch of T = B, with that batch's
capacity (and its drops), as the reference does.

The vision stub (``modality="vision_stub"``): ``extra_embeds`` (B, Sv, D)
stand for a vision encoder's patch embeddings; projected by ``vis_proj``
they replace the first Sv token embeddings. Every position, the stub's
included, takes the text position id on all three M-RoPE channels.

Cache layout (as the reference's): dict(k=(L, B, C, KV, hd), v=..., len)
with C = min(seq_len, sliding_window), a ring buffer indexed by
slot = position % C. ``len`` is a Python int here. ``decode_step`` writes
the new token's K/V into the cache's tensors in place and returns the
same tensors with ``len + 1``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import (
    ParamModule,
    _const,
    _expand_kv,
    _normal,
    apply_rope,
    blocked_attention,
    decode_attention,
    layernorm,
    maybe_remat,
    mlp_apply,
    moe_apply,
    naive_attention,
    rmsnorm,
)
from .losses import lm_loss

__all__ = ["DenseBlock", "Transformer", "attend", "cache_capacity", "_to_ring"]


class DenseBlock(ParamModule):
    """One transformer layer: pre-norm attention + pre-norm gated MLP, or
    for the MoE family pre-norm routed experts: ``router`` (D, E),
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        dt = cfg.torch_dtype
        D, L, F = cfg.d_model, cfg.n_layers, cfg.d_ff
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        out_scale = 0.02 / max(L, 1) ** 0.5
        spec = {
            "ln1": _const((D,), 0.0, dt),
            "ln2": _const((D,), 0.0, dt),
            "wq": _normal((D, H * hd), 0.02, dt),
            "wk": _normal((D, KV * hd), 0.02, dt),
            "wv": _normal((D, KV * hd), 0.02, dt),
            "wo": _normal((H * hd, D), out_scale, dt),
        }
        if cfg.norm == "layernorm":
            spec["ln1_b"] = _const((D,), 0.0, dt)
            spec["ln2_b"] = _const((D,), 0.0, dt)
        if cfg.qk_norm:
            spec["q_norm"] = _const((hd,), 0.0, dt)
            spec["k_norm"] = _const((hd,), 0.0, dt)
        if cfg.family == "moe":
            E = cfg.n_experts
            spec["router"] = _normal((D, E), 0.02, dt)
            spec["w_gate"] = _normal((E, D, F), 0.02, dt)
            spec["w_up"] = _normal((E, D, F), 0.02, dt)
            spec["w_down"] = _normal((E, F, D), out_scale, dt)
        else:
            spec["w_gate"] = _normal((D, F), 0.02, dt)
            spec["w_up"] = _normal((D, F), 0.02, dt)
            spec["w_down"] = _normal((F, D), out_scale, dt)
        super().__init__(spec, device)


def _norm(cfg: ModelConfig, x, scale, bias=None):
    if cfg.norm == "layernorm":
        return layernorm(x, scale, bias)
    return rmsnorm(x, scale)


def _positions(cfg: ModelConfig, B: int, S: int, device):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :].expand(B, S)
    if cfg.mrope_sections is not None:
        # Text tokens: all three M-RoPE channels share the position id.
        pos = pos[None].expand(3, B, S)
    return pos


def _attn_qkv(cfg: ModelConfig, lp, h, positions):
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (h @ lp.wq).reshape(B, S, H, hd)
    k = (h @ lp.wk).reshape(B, S, KV, hd)
    v = (h @ lp.wv).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, lp.q_norm)
        k = rmsnorm(k, lp.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction, cfg.mrope_sections)
    return q, k, v


def _self_attention(cfg: ModelConfig, lp, x, positions):
    """Pre-norm attention sub-block. Returns (residual_out, (k, v))."""
    B, S, _ = x.shape
    h = _norm(cfg, x, lp.ln1, getattr(lp, "ln1_b", None))
    q, k, v = _attn_qkv(cfg, lp, h, positions)
    o = attend(cfg, q, k, v).reshape(B, S, cfg.n_heads * cfg.d_head) @ lp.wo
    return x + o, (k, v)


def attend(cfg: ModelConfig, q, k, v):
    """Causal (and, with ``sliding_window``, windowed) attention over a
    full sequence, q (B, S, H, hd), k/v (B, S, KV, hd): the flash-attention
    kernel for ``attn_impl="kernel"``, which reads K/V at their own head
    count (GQA, MQA), else the plain path (full-matrix, or blocked above
    1024 tokens, as in the reference)."""
    S = q.shape[1]
    if cfg.attn_impl == "kernel":
        return ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    kx = _expand_kv(k, cfg.q_per_kv)
    vx = _expand_kv(v, cfg.q_per_kv)
    if S > 1024 and S % cfg.attn_block_q == 0 and S % cfg.attn_block_kv == 0:
        return blocked_attention(
            q, kx, vx, causal=True, window=cfg.sliding_window,
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv,
        )
    return naive_attention(q, kx, vx, causal=True, window=cfg.sliding_window)


def _ffn(cfg: ModelConfig, lp, x):
    """Pre-norm FFN sub-block: (residual out, the MoE aux loss, or None for
    a dense layer)."""
    B, S, D = x.shape
    h = _norm(cfg, x, lp.ln2, getattr(lp, "ln2_b", None))
    if cfg.family == "moe":
        out, aux = moe_apply(
            h.reshape(B * S, D), lp, cfg.n_experts, cfg.experts_per_token,
            cfg.capacity_factor, act=cfg.mlp_act, groups=cfg.moe_groups,
            shard_axis=cfg.moe_shard_axis,
        )
        return x + out.reshape(B, S, D), aux
    return x + mlp_apply(h, lp, cfg.mlp_act), None


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def _to_ring(k: torch.Tensor, S: int, C: int) -> torch.Tensor:
    """(B, S, ...) prefill K/V -> (B, C, ...) ring cache with slot = pos % C.

    C > S: empty slots at the end (headroom for decode); C <= S: the last
    C entries, rolled into ring position."""
    if C >= S:
        pad = k.new_zeros((k.shape[0], C - S, *k.shape[2:]))
        return torch.cat([k, pad], dim=1)
    return torch.roll(k[:, S - C:], S % C, dims=1)


class Transformer(ParamModule):
    """Decoder-only LM (training and serving). Its own parameters are the
    embedding, the final norm, the untied head and the vision stub's
    projector ``vis_proj`` (D, D); ``layers`` holds the blocks."""

    def __init__(self, cfg: ModelConfig, device="cuda") -> None:
        cfg.validate()
        dt = cfg.torch_dtype
        D, V = cfg.d_model, cfg.vocab
        spec = {"embed": _normal((V, D), 0.02, dt), "final_norm": _const((D,), 0.0, dt)}
        if cfg.norm == "layernorm":
            spec["final_norm_b"] = _const((D,), 0.0, dt)
        if not cfg.tie_embeddings:
            spec["lm_head"] = _normal((D, V), 0.02, dt)
        if cfg.modality == "vision_stub":
            spec["vis_proj"] = _normal((D, D), 0.02, dt)
        super().__init__(spec, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DenseBlock(cfg, device) for _ in range(cfg.n_layers)
        )

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Transformer":
        super().init_(generator)
        for blk in self.layers:
            blk.init_(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- pieces -----------------------------------------------------------

    def _embed(self, tokens: torch.Tensor, extra_embeds=None) -> torch.Tensor:
        x = self.embed[tokens.long()]  # (B, S, D)
        if extra_embeds is not None:
            # Modality stub: the projected embeddings replace the leading
            # positions.
            ee = extra_embeds.to(x.dtype)
            if ee.shape[1] > x.shape[1]:
                raise ValueError(
                    f"{ee.shape[1]} stub positions do not fit a prompt of {x.shape[1]}"
                )
            if self.cfg.modality == "vision_stub":
                ee = ee @ self.vis_proj
            x = torch.cat([ee, x[:, ee.shape[1]:]], dim=1)
        return x

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return _norm(self.cfg, x, self.final_norm, getattr(self, "final_norm_b", None))

    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return hidden @ head

    # ---- training -----------------------------------------------------------

    def forward(
        self, tokens: torch.Tensor, extra_embeds=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward: (hidden (B, S, D) after the final norm,
        moe_aux summed over the layers; 0 for a dense model). Each layer
        runs under ``maybe_remat``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens, extra_embeds)
        positions = _positions(cfg, B, S, x.device)

        def block(x, lp):
            x, _ = _self_attention(cfg, lp, x, positions)
            return _ffn(cfg, lp, x)

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            x, a = maybe_remat(lambda u, lp=lp: block(u, lp), cfg.remat)(x)
            if a is not None:
                aux = aux + a
        return self._final(x), aux

    def loss(self, batch: dict) -> Tuple[torch.Tensor, dict]:
        """The reference's loss_fn: mean token NLL (row-weighted when the
        batch has ``loss_weights``) plus ``router_aux_weight * moe_aux``;
        returns (total, {"nll", "moe_aux"}). A vision-stub batch may carry
        ``extra_embeds``."""
        hidden, aux = self.forward(batch["tokens"], batch.get("extra_embeds"))
        logits = self.logits_from_hidden(hidden)
        loss = lm_loss(logits, batch["labels"], batch.get("loss_weights"))
        total = loss + self.cfg.router_aux_weight * aux
        return total, {"nll": loss, "moe_aux": aux}

    # ---- serving ----------------------------------------------------------

    def init_cache(self, B: int, seq_len: int) -> dict:
        cfg = self.cfg
        C = cache_capacity(cfg, seq_len)
        shape = (cfg.n_layers, B, C, cfg.n_kv_heads, cfg.d_head)
        dt, dev = cfg.torch_dtype, self.device
        return {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": 0,  # tokens seen; write slot = len % C
        }

    @torch.no_grad()
    def prefill(
        self, tokens: torch.Tensor, extra_embeds=None, extra_slots: int = 0
    ) -> Tuple[torch.Tensor, dict]:
        """Run the full prompt (B, S), its first positions replaced by
        ``extra_embeds`` when given; return the last position's logits
        (B, 1, V) and the KV cache with ``extra_slots`` of decode headroom."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens, extra_embeds)
        positions = _positions(cfg, B, S, x.device)
        cache = self.init_cache(B, S + extra_slots)
        C = cache["k"].shape[2]
        for l, lp in enumerate(self.layers):
            x, (k, v) = _self_attention(cfg, lp, x, positions)
            x, _ = _ffn(cfg, lp, x)
            cache["k"][l] = _to_ring(k, S, C)
            cache["v"][l] = _to_ring(v, S, C)
        x = self._final(x)
        cache["len"] = S
        return self.logits_from_hidden(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(
        self, cache: dict, token: torch.Tensor
    ) -> Tuple[torch.Tensor, dict]:
        """One decode step (token (B, 1)) against the ring KV cache; writes
        the cache in place. Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        B = token.shape[0]
        x = self._embed(token)
        C = cache["k"].shape[2]
        n = cache["len"]  # true position id of this token
        slot = n % C
        positions = torch.full((B, 1), n, dtype=torch.int32, device=x.device)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, 1)
        valid = (torch.arange(C, device=x.device) < min(n + 1, C))[None].expand(B, C)
        for l, lp in enumerate(self.layers):
            kc, vc = cache["k"][l], cache["v"][l]
            h = _norm(cfg, x, lp.ln1, getattr(lp, "ln1_b", None))
            q, k, v = _attn_qkv(cfg, lp, h, positions)
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            o = decode_attention(q, kc, vc, valid)
            x = x + o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ lp.wo
            x, _ = _ffn(cfg, lp, x)
        x = self._final(x)
        return self.logits_from_hidden(x), {"k": cache["k"], "v": cache["v"], "len": n + 1}
