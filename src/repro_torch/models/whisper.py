"""Whisper-style encoder-decoder transformer backbone [arXiv:2212.04356]
(port of `repro.models.whisper`).

The audio frontend (mel-spectrogram and conv feature extractor) is a
stub, as in the reference: ``extra_embeds`` are precomputed frame
embeddings (B, encoder_positions, D). ``Whisper`` is an ``nn.Module``
whose ``enc`` and ``dec`` are ``nn.ModuleList``s of per-layer blocks with
the reference's parameter names and ``(in, out)`` weights, so
`repro_torch.models.params.from_reference` loads a layer as a slice of
the reference's stacked arrays. Its entry points:

  forward(tokens, extra_embeds) -> (hidden (B, S, D), moe_aux = 0)
  loss(batch)     -> (loss, metrics)     the reference's loss_fn (tied head)
  encode(frames)  -> encoder output (B, encoder_positions, D)
  prefill(tokens, extra_embeds, extra_slots=0) -> (last logits, cache)
  decode_step(cache, token)              -> (logits, cache)
  init_cache(B, seq_len)

Encoder blocks are pre-LayerNorm bidirectional self-attention then a
tanh-gelu MLP; decoder blocks add cross-attention over the encoder output
between the two. Attention is the reference's jnp path, never the
flash-attention kernel: `layers.blocked_attention` when it is causal
self-attention over more than 1024 positions that divide by both
blocks, `layers.naive_attention` otherwise (``attn_impl`` changes
nothing here, as in the reference). The encoder and decoder layers run
under ``maybe_remat`` when gradients are on.

Cache: the decoder's self-attention ring ``k``/``v`` (L, B, C, KV, hd)
with C = prompt + ``extra_slots``, the cross-attention ``xk``/``xv``
(L, B, encoder_positions, KV, hd) projected once per layer from the
encoder output, and ``len`` a Python int. ``decode_step`` writes the ring
in place. Its position embedding index is clamped to the table's last
row, as JAX clamps an index past the end.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import (
    ParamModule,
    _const,
    _expand_kv,
    _normal,
    blocked_attention,
    decode_attention,
    layernorm,
    maybe_remat,
    mlp_apply,
    naive_attention,
)
from .losses import lm_loss
from .transformer import _to_ring

__all__ = ["Whisper", "WhisperBlock", "DEC_POSITIONS"]

# Rows of the decoder's learned position table (the reference's; Whisper
# itself has 448).
DEC_POSITIONS = 32768


def _attn_spec(cfg: ModelConfig, prefix: str = "") -> dict:
    dt = cfg.torch_dtype
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        f"{prefix}ln": _const((D,), 1.0, dt),
        f"{prefix}ln_b": _const((D,), 0.0, dt),
        f"{prefix}wq": _normal((D, H * hd), 0.02, dt),
        f"{prefix}wk": _normal((D, KV * hd), 0.02, dt),
        f"{prefix}wv": _normal((D, KV * hd), 0.02, dt),
        f"{prefix}wo": _normal((H * hd, D), 0.005, dt),
    }


class WhisperBlock(ParamModule):
    """One encoder layer (self-attention ``ln``/``wq``.., MLP ``mln``/
    ``w_in``/``w_out``) or, with ``cross``, one decoder layer, which adds
    the cross-attention's ``x_ln``/``x_wq``.. Norm scales start at ones."""

    def __init__(self, cfg: ModelConfig, device, cross: bool) -> None:
        dt = cfg.torch_dtype
        D, F = cfg.d_model, cfg.d_ff
        spec = _attn_spec(cfg)
        if cross:
            spec.update(_attn_spec(cfg, "x_"))
        spec.update({
            "mln": _const((D,), 1.0, dt),
            "mln_b": _const((D,), 0.0, dt),
            "w_in": _normal((D, F), 0.02, dt),
            "w_out": _normal((F, D), 0.005, dt),
        })
        super().__init__(spec, device)


def _mha(cfg: ModelConfig, lp, xq, xkv, causal: bool, prefix: str = ""):
    """Attention of ``xq`` over ``xkv`` with the ``prefix``ed weights:
    (output projected by ``wo`` (B, Sq, D), (k, v) (B, Skv, KV, hd))."""
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (xq @ getattr(lp, f"{prefix}wq")).reshape(B, Sq, H, hd)
    k = (xkv @ getattr(lp, f"{prefix}wk")).reshape(B, Skv, KV, hd)
    v = (xkv @ getattr(lp, f"{prefix}wv")).reshape(B, Skv, KV, hd)
    kx, vx = _expand_kv(k, cfg.q_per_kv), _expand_kv(v, cfg.q_per_kv)
    if (causal and Sq == Skv and Sq > 1024
            and Sq % cfg.attn_block_q == 0 and Sq % cfg.attn_block_kv == 0):
        o = blocked_attention(q, kx, vx, causal=True,
                              block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    else:
        o = naive_attention(q, kx, vx, causal)
    return o.reshape(B, Sq, H * hd) @ getattr(lp, f"{prefix}wo"), (k, v)


def _encoder_block(cfg: ModelConfig, lp, x):
    h = layernorm(x, lp.ln, lp.ln_b)
    x = x + _mha(cfg, lp, h, h, causal=False)[0]
    h = layernorm(x, lp.mln, lp.mln_b)
    return x + mlp_apply(h, lp, "gelu")


def _decoder_block(cfg: ModelConfig, lp, x, enc_out):
    """(x out, self-attention (k, v), cross-attention (k, v))."""
    h = layernorm(x, lp.ln, lp.ln_b)
    o, kv = _mha(cfg, lp, h, h, causal=True)
    x = x + o
    h = layernorm(x, lp.x_ln, lp.x_ln_b)
    o, xkv = _mha(cfg, lp, h, enc_out, causal=False, prefix="x_")
    x = x + o
    h = layernorm(x, lp.mln, lp.mln_b)
    return x + mlp_apply(h, lp, "gelu"), kv, xkv


class Whisper(ParamModule):
    """Encoder-decoder LM (training and serving). Its own parameters are
    the position tables ``enc_pos`` (encoder_positions, D) and ``dec_pos``
    (32768, D), the tied embedding and the two final norms."""

    def __init__(self, cfg: ModelConfig, device="cuda") -> None:
        cfg.validate()
        dt = cfg.torch_dtype
        D = cfg.d_model
        spec = {
            "enc_pos": _normal((cfg.encoder_positions, D), 0.01, dt),
            "enc_norm": _const((D,), 1.0, dt),
            "enc_norm_b": _const((D,), 0.0, dt),
            "embed": _normal((cfg.vocab, D), 0.02, dt),
            "dec_pos": _normal((DEC_POSITIONS, D), 0.01, dt),
            "dec_norm": _const((D,), 1.0, dt),
            "dec_norm_b": _const((D,), 0.0, dt),
        }
        super().__init__(spec, device)
        self.cfg = cfg
        self.enc = nn.ModuleList(
            WhisperBlock(cfg, device, cross=False) for _ in range(cfg.encoder_layers)
        )
        self.dec = nn.ModuleList(
            WhisperBlock(cfg, device, cross=True) for _ in range(cfg.n_layers)
        )

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Whisper":
        super().init_(generator)
        for blk in (*self.enc, *self.dec):
            blk.init_(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _remat(self) -> str:
        # Checkpointing only pays where there is a backward pass.
        return self.cfg.remat if torch.is_grad_enabled() else "none"

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.embed.T

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, encoder_positions, D) -> the encoder's output."""
        cfg = self.cfg
        want = (cfg.encoder_positions, cfg.d_model)
        if frames is None or frames.dim() != 3 or tuple(frames.shape[1:]) != want:
            got = None if frames is None else tuple(frames.shape)
            raise ValueError(f"Whisper needs frames (B, {want[0]}, {want[1]}) as "
                             f"extra_embeds, got {got}")
        x = frames.to(cfg.torch_dtype) + self.enc_pos[None]
        remat = self._remat()
        for lp in self.enc:
            x = maybe_remat(lambda u, lp=lp: _encoder_block(cfg, lp, u), remat)(x)
        return layernorm(x, self.enc_norm, self.enc_norm_b)

    def _decoder_input(self, tokens: torch.Tensor) -> torch.Tensor:
        S = tokens.shape[1]
        return self.embed[tokens.long()] + self.dec_pos[:S][None]

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.dec_norm, self.dec_norm_b)

    # ---- training -----------------------------------------------------------

    def forward(
        self, tokens: torch.Tensor, extra_embeds=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hidden (B, S, D) after the decoder's final norm, a zero moe_aux)
        of ``tokens`` (B, S) over the frames ``extra_embeds``."""
        cfg = self.cfg
        enc_out = self.encode(extra_embeds)
        x = self._decoder_input(tokens)
        remat = self._remat()
        for lp in self.dec:
            x = maybe_remat(
                lambda u, e, lp=lp: _decoder_block(cfg, lp, u, e)[0], remat
            )(x, enc_out)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._final(x), aux

    def loss(self, batch: dict) -> Tuple[torch.Tensor, dict]:
        """The reference's loss_fn: mean token NLL of the tied head (row-
        weighted when the batch has ``loss_weights``); the batch carries the
        frames as ``extra_embeds``."""
        hidden, aux = self.forward(batch["tokens"], batch.get("extra_embeds"))
        loss = lm_loss(self._logits(hidden), batch["labels"], batch.get("loss_weights"))
        return loss, {"nll": loss, "moe_aux": aux}

    # ---- serving ----------------------------------------------------------

    def init_cache(self, B: int, seq_len: int) -> dict:
        cfg = self.cfg
        L, KV, hd, Te = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, cfg.encoder_positions
        dt, dev = cfg.torch_dtype, self.device
        return {
            "k": torch.zeros((L, B, seq_len, KV, hd), dtype=dt, device=dev),
            "v": torch.zeros((L, B, seq_len, KV, hd), dtype=dt, device=dev),
            "xk": torch.zeros((L, B, Te, KV, hd), dtype=dt, device=dev),
            "xv": torch.zeros((L, B, Te, KV, hd), dtype=dt, device=dev),
            "len": 0,  # tokens seen; write slot = len % C
        }

    @torch.no_grad()
    def prefill(
        self, tokens: torch.Tensor, extra_embeds=None, extra_slots: int = 0
    ) -> Tuple[torch.Tensor, dict]:
        """Encode the frames, run the decoder over the prompt (B, S); return
        the last position's logits (B, 1, V) and the cache with
        ``extra_slots`` of decode headroom."""
        cfg = self.cfg
        B, S = tokens.shape
        enc_out = self.encode(extra_embeds)
        x = self._decoder_input(tokens)
        cache = self.init_cache(B, S + extra_slots)
        C = cache["k"].shape[2]
        for l, lp in enumerate(self.dec):
            x, (k, v), (xk, xv) = _decoder_block(cfg, lp, x, enc_out)
            cache["k"][l] = _to_ring(k, S, C)
            cache["v"][l] = _to_ring(v, S, C)
            cache["xk"][l] = xk
            cache["xv"][l] = xv
        cache["len"] = S
        return self._logits(self._final(x)[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step (token (B, 1)): self-attention over the ring,
        cross-attention over every encoder position. Writes the ring in
        place; returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        B = token.shape[0]
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        C, Te = cache["k"].shape[2], cache["xk"].shape[2]
        n = cache["len"]
        slot = n % C
        pos = min(n, self.dec_pos.shape[0] - 1)  # JAX clamps past the end
        x = self.embed[token.long()] + self.dec_pos[pos][None, None]
        dev = x.device
        valid = (torch.arange(C, device=dev) < min(n + 1, C))[None].expand(B, C)
        valid_x = torch.ones((B, Te), dtype=torch.bool, device=dev)
        for l, lp in enumerate(self.dec):
            kc, vc = cache["k"][l], cache["v"][l]
            h = layernorm(x, lp.ln, lp.ln_b)
            q = (h @ lp.wq).reshape(B, 1, H, hd)
            kc[:, slot] = (h @ lp.wk).reshape(B, KV, hd)
            vc[:, slot] = (h @ lp.wv).reshape(B, KV, hd)
            o = decode_attention(q, kc, vc, valid)
            x = x + o.reshape(B, 1, H * hd) @ lp.wo
            h = layernorm(x, lp.x_ln, lp.x_ln_b)
            q = (h @ lp.x_wq).reshape(B, 1, H, hd)
            o = decode_attention(q, cache["xk"][l], cache["xv"][l], valid_x)
            x = x + o.reshape(B, 1, H * hd) @ lp.x_wo
            h = layernorm(x, lp.mln, lp.mln_b)
            x = x + mlp_apply(h, lp, "gelu")
        logits = self._logits(self._final(x))
        return logits, dict(cache, len=n + 1)
