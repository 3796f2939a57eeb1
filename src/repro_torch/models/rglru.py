"""RecurrentGemma / Griffin hybrid: RG-LRU recurrence + local attention
[arXiv:2402.19427] (port of `repro.models.rglru`).

The layer pattern is the reference's: G = n_layers // attn_every groups of
[R = attn_every - 1 recurrent layers, 1 local-attention layer], then a
tail of T = n_layers % attn_every recurrent layers. ``RecurrentGemma``
holds them as ``rec[g][r]``, ``attn[g]`` and ``tail_rec[t]`` (nested
``nn.ModuleList``s), so each block is the reference's stacked parameters
sliced at its index, with the same names.

RG-LRU (per channel):
  r_t = sigmoid(x_t W_a + b_a)          recurrence gate
  i_t = sigmoid(x_t W_x + b_x)          input gate
  log a_t = -c * softplus(Lambda) * r_t          (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence blocks (training's ``forward``/``loss`` and prefill)
compute the gates as batched products and the recurrence with the RG-LRU
scan kernel (``ssm_impl="kernel"``, differentiable on the card through its
backward kernel) or, on the plain path, a doubling (parallel-prefix) scan
like the reference's associative scan; the local attention goes through
the flash-attention kernel (``attn_impl="kernel"``, likewise
differentiable) or the plain path, which is the reference's (it has no
kernel on this layer). Decode is plain. ``forward`` runs the reference's
layer order, each group of [R recurrent layers, 1 attention layer] under
``maybe_remat``, then the tail; the layers compute in float32 (float64
for float64 weights).

Cache (the reference's layout): lru (G, R, B, W) f32, conv
(G, R, B, cw-1, W), k/v (G, B, C, KV, hd) ring with C = min(S + extra,
window), ``len`` (a Python int), and tail_lru/tail_conv when T > 0.
``decode_step`` updates the cache's tensors in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import compute_dtype

from .config import ModelConfig
from .layers import (
    ParamModule,
    _const,
    _normal,
    apply_rope,
    causal_conv,
    decode_attention,
    gelu,
    maybe_remat,
    mlp_apply,
    rmsnorm,
)
from .losses import lm_loss
from .transformer import _to_ring, attend

__all__ = ["RecBlock", "AttnBlock", "RecurrentGemma", "rglru_seq", "rglru_step"]

_C_RGLRU = 8.0


def _counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    G = cfg.n_layers // cfg.attn_every
    R = cfg.attn_every - 1
    T = cfg.n_layers % cfg.attn_every  # tail recurrent layers
    return G, R, T


# --------------------------------------------------------------------------
# Blocks (parameters)
# --------------------------------------------------------------------------


def _mlp_spec(cfg: ModelConfig) -> dict:
    D, F_, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    return {
        "ln2": _const((D,), 0.0, dt),
        "w_gate": _normal((D, F_), 0.02, dt),
        "w_up": _normal((D, F_), 0.02, dt),
        "w_down": _normal((F_, D), 0.005, dt),
    }


class RecBlock(ParamModule):
    """Recurrent layer: RG-LRU branch (gated, after a causal conv) + MLP."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        D, Wl, cw, dt = cfg.d_model, cfg.lru_width, cfg.conv_width, cfg.torch_dtype
        f32 = torch.float32
        super().__init__(
            {
                "ln": _const((D,), 0.0, dt),
                "w_x": _normal((D, Wl), 0.02, dt),
                "w_gate_in": _normal((D, Wl), 0.02, dt),
                "conv_w": _normal((cw, Wl), 0.2, dt),
                "conv_b": _const((Wl,), 0.0, dt),
                "lru_wa": _normal((Wl, Wl), 0.02, dt),
                "lru_ba": _const((Wl,), 2.0, f32),
                "lru_wx": _normal((Wl, Wl), 0.02, dt),
                "lru_bx": _const((Wl,), 0.0, f32),
                "lambda": _const((Wl,), 1.0, f32),
                "w_out": _normal((Wl, D), 0.005, dt),
                **_mlp_spec(cfg),
            },
            device,
        )


class AttnBlock(ParamModule):
    """Local (sliding-window) attention layer + MLP."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        D, dt = cfg.d_model, cfg.torch_dtype
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        super().__init__(
            {
                "ln": _const((D,), 0.0, dt),
                "wq": _normal((D, H * hd), 0.02, dt),
                "wk": _normal((D, KV * hd), 0.02, dt),
                "wv": _normal((D, KV * hd), 0.02, dt),
                "wo": _normal((H * hd, D), 0.005, dt),
                **_mlp_spec(cfg),
            },
            device,
        )


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------


def _gates(lp, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32 (float64
    for float64 inputs). x (B, S, W)."""
    ct = compute_dtype(x.dtype)
    xf = x.to(ct)
    r = torch.sigmoid(xf @ lp.lru_wa.to(ct) + lp.lru_ba.to(ct))
    i = torch.sigmoid(xf @ lp.lru_wx.to(ct) + lp.lru_bx.to(ct))
    log_a = -_C_RGLRU * F.softplus(getattr(lp, "lambda").to(ct)) * r  # (B, S, W)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def rglru_seq(
    lp, x: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence over the sequence by a doubling (Hillis-Steele)
    scan, the plain twin of the reference's associative scan.

    x: (B, S, W); h0: (B, W) carried state. Returns (h_seq in x's dtype,
    h_last in the gates' type)."""
    a, b = _gates(lp, x)
    # Fold the initial state into the first step: b_1 += a_1 * h0.
    b = b.clone()
    b[:, 0] += a[:, 0] * h0.to(b.dtype)
    S = a.shape[1]
    stride = 1
    while stride < S:
        # (a1, b1) then (a2, b2) composes to (a1 a2, a2 b1 + b2).
        b_prev = F.pad(b[:, :-stride], (0, 0, stride, 0))
        a_prev = F.pad(a[:, :-stride], (0, 0, stride, 0), value=1.0)
        b = a * b_prev + b
        a = a * a_prev
        stride *= 2
    return b.to(x.dtype), b[:, -1]


def rglru_step(
    lp, x: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x: (B, 1, W), h: (B, W) f32."""
    a, b = _gates(lp, x)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x.dtype)[:, None], h_new


# --------------------------------------------------------------------------
# Blocks (full sequence)
# --------------------------------------------------------------------------


def _rec_block_seq(cfg: ModelConfig, lp, x, h0: Optional[torch.Tensor] = None):
    B = x.shape[0]
    h = rmsnorm(x, lp.ln)
    gate = gelu((h @ lp.w_gate_in).to(compute_dtype(x.dtype))).to(x.dtype)
    xb = h @ lp.w_x
    xb = causal_conv(xb, lp.conv_w, lp.conv_b)
    if h0 is None:
        h0 = torch.zeros((B, cfg.lru_width), dtype=compute_dtype(x.dtype), device=x.device)
    if cfg.ssm_impl == "kernel":
        a, bb = _gates(lp, xb)
        hs, h_last = ops.rglru_scan(a, bb, h0)
        ys = hs.to(xb.dtype)
    else:
        ys, h_last = rglru_seq(lp, xb, h0)
    x = x + (ys * gate) @ lp.w_out
    x = x + mlp_apply(rmsnorm(x, lp.ln2), lp, "geglu")
    return x, h_last


def _attn_block_seq(cfg: ModelConfig, lp, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rmsnorm(x, lp.ln)
    q = (h @ lp.wq).reshape(B, S, H, hd)
    k_ = (h @ lp.wk).reshape(B, S, KV, hd)
    v = (h @ lp.wv).reshape(B, S, KV, hd)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_ = apply_rope(k_, pos, cfg.rope_theta)
    o = attend(cfg, q, k_, v)  # the plain path is the reference's (it has no kernel here)
    x = x + o.reshape(B, S, H * hd) @ lp.wo
    x = x + mlp_apply(rmsnorm(x, lp.ln2), lp, "geglu")
    return x, (k_, v)


# --------------------------------------------------------------------------
# Blocks (one decode token)
# --------------------------------------------------------------------------


def _rec_block_step(cfg: ModelConfig, lp, x, h_lru, conv_tail):
    """Decode one token through a recurrent block. Returns (x, new LRU
    state, new conv tail)."""
    h = rmsnorm(x, lp.ln)
    gate = gelu((h @ lp.w_gate_in).float()).to(x.dtype)
    xb = h @ lp.w_x  # (B, 1, W)
    window = torch.cat([conv_tail, xb], dim=1)  # (B, cw, W)
    conv = torch.einsum("bwc,wc->bc", window.float(), lp.conv_w.float()) + lp.conv_b.float()
    xb = conv[:, None].to(x.dtype)
    ys, h_new = rglru_step(lp, xb, h_lru)
    x = x + (ys * gate) @ lp.w_out
    x = x + mlp_apply(rmsnorm(x, lp.ln2), lp, "geglu")
    return x, h_new, window[:, 1:]


def _attn_block_step(cfg: ModelConfig, lp, x, kc, vc, slot: int, pos_t: int, valid):
    """Decode one token through a local-attention block; writes the new
    K/V into the ring slices ``kc``/``vc`` in place."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rmsnorm(x, lp.ln)
    q = (h @ lp.wq).reshape(B, 1, H, hd)
    k_ = (h @ lp.wk).reshape(B, 1, KV, hd)
    v = (h @ lp.wv).reshape(B, 1, KV, hd)
    pos = torch.full((B, 1), pos_t, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_ = apply_rope(k_, pos, cfg.rope_theta)
    kc[:, slot] = k_[:, 0]
    vc[:, slot] = v[:, 0]
    o = decode_attention(q, kc, vc, valid)
    x = x + o.reshape(B, 1, H * hd) @ lp.wo
    x = x + mlp_apply(rmsnorm(x, lp.ln2), lp, "geglu")
    return x


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


class RecurrentGemma(ParamModule):
    """Hybrid RG-LRU + local-attention LM (training and serving). Its own
    parameters are the embedding, the final norm and the untied head."""

    def __init__(self, cfg: ModelConfig, device="cuda") -> None:
        cfg.validate()
        dt = cfg.torch_dtype
        D, V = cfg.d_model, cfg.vocab
        spec = {"embed": _normal((V, D), 0.02, dt), "final_norm": _const((D,), 0.0, dt)}
        if not cfg.tie_embeddings:
            spec["lm_head"] = _normal((D, V), 0.02, dt)
        super().__init__(spec, device)
        self.cfg = cfg
        G, R, T = _counts(cfg)
        self.rec = nn.ModuleList(
            nn.ModuleList(RecBlock(cfg, device) for _ in range(R)) for _ in range(G)
        )
        self.attn = nn.ModuleList(AttnBlock(cfg, device) for _ in range(G))
        self.tail_rec = nn.ModuleList(RecBlock(cfg, device) for _ in range(T))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "RecurrentGemma":
        super().init_(generator)
        for g, attn in enumerate(self.attn):
            for blk in self.rec[g]:
                blk.init_(generator)
            attn.init_(generator)
        for blk in self.tail_rec:
            blk.init_(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    # ---- training -----------------------------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Hidden states (B, S, D) after the final norm: each group of R
        recurrent layers and one attention layer under ``maybe_remat`` (the
        reference's remat of its group scan), then the tail recurrent
        layers."""
        cfg = self.cfg
        x = self.embed[tokens.long()]

        def group(x, g):
            for lp in self.rec[g]:
                x, _ = _rec_block_seq(cfg, lp, x)
            return _attn_block_seq(cfg, self.attn[g], x)[0]

        for g in range(len(self.attn)):
            x = maybe_remat(lambda u, g=g: group(u, g), cfg.remat)(x)
        for lp in self.tail_rec:
            x, _ = _rec_block_seq(cfg, lp, x)
        return rmsnorm(x, self.final_norm)

    def loss(self, batch: dict) -> Tuple[torch.Tensor, dict]:
        """The reference's loss_fn: mean token NLL (row-weighted when the
        batch has ``loss_weights``); returns (loss, {"nll", "moe_aux"})."""
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = self.forward(batch["tokens"]) @ head
        loss = lm_loss(logits, batch["labels"], batch.get("loss_weights"))
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"nll": loss, "moe_aux": zero}

    def init_cache(self, B: int, seq_len: int) -> dict:
        cfg = self.cfg
        G, R, T = _counts(cfg)
        Wl, cw, hd, KV = cfg.lru_width, cfg.conv_width, cfg.d_head, cfg.n_kv_heads
        C = min(seq_len, cfg.sliding_window or seq_len)
        dt, dev, f32 = cfg.torch_dtype, self.device, torch.float32
        cache = {
            "lru": torch.zeros((G, R, B, Wl), dtype=f32, device=dev),
            "conv": torch.zeros((G, R, B, cw - 1, Wl), dtype=dt, device=dev),
            "k": torch.zeros((G, B, C, KV, hd), dtype=dt, device=dev),
            "v": torch.zeros((G, B, C, KV, hd), dtype=dt, device=dev),
            "len": 0,
        }
        if T:
            cache["tail_lru"] = torch.zeros((T, B, Wl), dtype=f32, device=dev)
            cache["tail_conv"] = torch.zeros((T, B, cw - 1, Wl), dtype=dt, device=dev)
        return cache

    def _rec_prefill(self, lp, x, S: int):
        """One recurrent layer over the prompt; returns (x, LRU state, conv
        tail). The conv tail is the branch input before the conv, so it is
        recomputed from the layer's input."""
        cw = self.cfg.conv_width
        xb_raw = rmsnorm(x, lp.ln) @ lp.w_x
        x, h_last = _rec_block_seq(self.cfg, lp, x)
        return x, h_last, xb_raw[:, S - (cw - 1):]

    @torch.no_grad()
    def prefill(
        self, tokens: torch.Tensor, extra_slots: int = 0
    ) -> Tuple[torch.Tensor, dict]:
        """Run the prompt (B, S); return the last position's logits (B, 1, V)
        and the cache with ``extra_slots`` of decode headroom."""
        cfg = self.cfg
        B, S = tokens.shape
        cache = self.init_cache(B, S + extra_slots)
        C = cache["k"].shape[2]
        x = self.embed[tokens.long()]
        for g, attn in enumerate(self.attn):
            for r, lp in enumerate(self.rec[g]):
                x, cache["lru"][g, r], cache["conv"][g, r] = self._rec_prefill(lp, x, S)
            x, (k_, v) = _attn_block_seq(cfg, attn, x)
            cache["k"][g] = _to_ring(k_, S, C)
            cache["v"][g] = _to_ring(v, S, C)
        for t, lp in enumerate(self.tail_rec):
            x, cache["tail_lru"][t], cache["tail_conv"][t] = self._rec_prefill(lp, x, S)
        cache["len"] = S
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(
        self, cache: dict, token: torch.Tensor
    ) -> Tuple[torch.Tensor, dict]:
        """One decode step (token (B, 1)); updates the cache in place.
        Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        B = token.shape[0]
        C = cache["k"].shape[2]
        n = cache["len"]
        slot = n % C
        valid = (torch.arange(C, device=token.device) < min(n + 1, C))[None].expand(B, C)
        x = self.embed[token.long()]
        for g, attn in enumerate(self.attn):
            for r, lp in enumerate(self.rec[g]):
                x, h_new, c_new = _rec_block_step(
                    cfg, lp, x, cache["lru"][g, r], cache["conv"][g, r]
                )
                cache["lru"][g, r] = h_new
                cache["conv"][g, r] = c_new
            x = _attn_block_step(
                cfg, attn, x, cache["k"][g], cache["v"][g], slot, n, valid
            )
        for t, lp in enumerate(self.tail_rec):
            x, h_new, c_new = _rec_block_step(
                cfg, lp, x, cache["tail_lru"][t], cache["tail_conv"][t]
            )
            cache["tail_lru"][t] = h_new
            cache["tail_conv"][t] = c_new
        new_cache = dict(cache)
        new_cache["len"] = n + 1
        return self._logits(x), new_cache
