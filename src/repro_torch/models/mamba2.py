"""Mamba-2 (SSD, state-space duality) language model [arXiv:2405.21060]
(port of `repro.models.mamba2`).

Block = RMSNorm -> mixer -> residual, the mixer being in_proj -> causal
depthwise conv (x, B, C) -> SSD -> gated RMSNorm -> out_proj
(``ssm_mixer``, with ``ssm_mixer_prefill`` / ``ssm_mixer_step`` for
serving; the granite family calls the same mixer with the gate before the
norm). ``Mamba2`` is an ``nn.Module`` whose ``layers`` is an
``nn.ModuleList`` of per-layer ``Mamba2Block``s with the reference's
parameter names and ``(in, out)`` weights, so
`repro_torch.models.params.from_reference` loads a layer as a slice of the
reference's stacked arrays. Its entry points:

  forward(tokens) -> hidden (B, S, D)        training forward
  loss(batch)     -> (loss, metrics)         the reference's loss_fn
  prefill(tokens, extra_slots=0) -> (last logits, cache)
  decode_step(cache, token)      -> (logits, cache)
  init_cache(B, seq_len)

The training forward's SSD runs through K4 (``ssm_impl="kernel"``:
`repro_torch.kernels.ops.ssd_scan`, the CUDA kernel on the card, with a
gradient) or the plain chunked form ``ssd_chunked`` (``"plain"``; it lives
in `repro_torch.kernels.ref`, beside the kernel it differentiates), layer
by layer under ``maybe_remat``; with ``"kernel"`` the causal conv + SiLU
before it runs through `repro_torch.kernels.ops.causal_conv_silu` too,
in training and prefill. Prefill always uses ``ssd_chunked`` (it
needs the final state, as in the reference) and decode the one-step
recurrence ``ssd_decode``.

The SSD algebra computes in ``promote(dtype, float32)``: float32 for the
bf16 and f32 models, as the reference, and float64 for float64 inputs
(the reference casts to float32 there; float64 serves the gradient
checks). Shapes: B batch, S seq, D d_model, di = expand * D, H heads,
P = di / H head dim, N state, Q chunk.

Cache (the reference's layout): ssm (L, B, H, P, N) float32, conv
(L, B, W - 1, conv_dim) with the pre-conv tail, ``len`` a Python int.
``decode_step`` writes the cache's tensors in place.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import causal_conv, compute_dtype, ssd_chunked

from .config import ModelConfig
from .layers import ParamModule, _const, _normal, maybe_remat, rmsnorm
from .losses import lm_loss

__all__ = ["Mamba2Block", "Mamba2", "ssd_chunked", "ssd_decode", "mixer_spec", "init_A_log",
           "ssm_mixer", "ssm_mixer_prefill", "ssm_mixer_step"]


def _dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim or di // H
    N = cfg.ssm_state
    conv_dim = di + 2 * N  # x, B, C pass through the conv (G = 1)
    return di, H, P, N, conv_dim


# --------------------------------------------------------------------------
# SSD decode (the chunked form ``ssd_chunked`` is in `repro_torch.kernels.ref`)
# --------------------------------------------------------------------------


def ssd_decode(
    x: torch.Tensor,  # (B, 1, H, P)
    dt: torch.Tensor,  # (B, 1, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, 1, N)
    Cm: torch.Tensor,  # (B, 1, N)
    h: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step recurrence: h = exp(dt A) h + (dt x) B^T; y = h C."""
    ct = compute_dtype(dt.dtype, h.dtype)
    a = torch.exp(dt[:, 0, :, None, None].to(ct) * A.to(ct)[None, :, None, None])
    xdt = x[:, 0].to(ct) * dt[:, 0, :, None].to(ct)
    h_new = a * h + xdt[..., None] * Bm[:, 0].to(ct)[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm[:, 0].to(ct))
    return y[:, None], h_new


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def mixer_spec(cfg: ModelConfig) -> dict:
    """The Mamba-2 mixer's parameters (``A_log``, ``dt_bias`` and
    ``D_skip`` in float32 whatever the model dtype)."""
    dt = cfg.torch_dtype
    D, L, W = cfg.d_model, cfg.n_layers, cfg.conv_width
    di, H, P, N, conv_dim = _dims(cfg)
    f32 = torch.float32
    return {
        # in_proj packs (z, x, B, C, dt): di + di + N + N + H columns
        "w_in": _normal((D, 2 * di + 2 * N + H), 0.02, dt),
        "conv_w": _normal((W, conv_dim), 0.2, dt),
        "conv_b": _const((conv_dim,), 0.0, dt),
        "A_log": _const((H,), 0.0, f32),  # set by init_A_log
        "dt_bias": _const((H,), 0.0, f32),
        "D_skip": _const((H,), 1.0, f32),
        "norm": _const((di,), 0.0, dt),
        "w_out": _normal((di, D), 0.02 / max(L, 1) ** 0.5, dt),
    }


@torch.no_grad()
def init_A_log(A_log: torch.Tensor) -> None:
    """The reference's A_log: log of H values evenly spaced over [1, 16]."""
    a = torch.log(torch.linspace(1.0, 16.0, A_log.shape[0], dtype=torch.float64))
    A_log.copy_(a.to(torch.float32))


class Mamba2Block(ParamModule):
    """One mamba2 layer: its pre-norm ``ln`` and the mixer's parameters,
    with the reference's exact values."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        spec = {"ln": _const((cfg.d_model,), 0.0, cfg.torch_dtype), **mixer_spec(cfg)}
        super().__init__(spec, device)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Mamba2Block":
        super().init_(generator)
        init_A_log(self.A_log)
        return self


def _block_seq(cfg: ModelConfig, lp, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 block (pre-norm residual), the training path."""
    return u + ssm_mixer(cfg, lp, rmsnorm(u, lp.ln))


def _mixer_in(cfg: ModelConfig, lp, h: torch.Tensor):
    """The mixer up to the scan, on a full sequence: (z, the pre-conv
    (x, B, C) whose tail a cache keeps, x (B, S, H, P), dt, A, B, C). The
    conv + SiLU runs through ``ops.causal_conv_silu`` for
    ``ssm_impl="kernel"`` (on the card one kernel each way, bit for bit
    the plain expression's forward), as that expression for ``"plain"``."""
    di, H, P, N, conv_dim = _dims(cfg)
    B_, S, _ = h.shape
    z, xBC_raw, dt_raw = torch.split(h @ lp.w_in, [di, conv_dim, H], dim=-1)
    if cfg.ssm_impl == "kernel":
        xBC = ops.causal_conv_silu(xBC_raw, lp.conv_w, lp.conv_b)
    else:
        xBC = F.silu(causal_conv(xBC_raw, lp.conv_w, lp.conv_b))
    x, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt, A = _dt_A(lp, dt_raw)
    return z, xBC_raw, x.reshape(B_, S, H, P), dt, A, Bm, Cm


def ssm_mixer(cfg: ModelConfig, lp, h: torch.Tensor, norm_before_gate: bool = True,
              eps: float = 1e-6) -> torch.Tensor:
    """The Mamba-2 mixer on a normed full sequence h (B, S, D), the
    training path: in-projection, causal conv, the SSD scan (K4 through
    ``ops.ssd_scan`` for ``ssm_impl="kernel"``, ``ssd_chunked`` for
    ``"plain"``), gated RMSNorm (`_gated_out`) and out-projection; no
    residual. Callers reach it through this module at call time, so a
    profiler's wrapper of the module attribute sees every call."""
    z, _, xh, dt, A, Bm, Cm = _mixer_in(cfg, lp, h)
    if cfg.ssm_impl == "kernel":
        y, _ = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    return _gated_out(lp, y, xh, z, norm_before_gate, eps)


def ssm_mixer_prefill(cfg: ModelConfig, lp, h: torch.Tensor, norm_before_gate: bool = True,
                      eps: float = 1e-6):
    """The mixer on a prompt (through ``ssd_chunked``, which gives the
    final state): (out, final SSM state (B, H, P, N), the conv tail
    (B, W - 1, conv_dim))."""
    S = h.shape[1]
    z, xBC_raw, xh, dt, A, Bm, Cm = _mixer_in(cfg, lp, h)
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    tail = xBC_raw[:, S - (cfg.conv_width - 1):]
    return _gated_out(lp, y, xh, z, norm_before_gate, eps), state, tail


def ssm_mixer_step(cfg: ModelConfig, lp, h: torch.Tensor, ssm: torch.Tensor,
                   conv: torch.Tensor, norm_before_gate: bool = True, eps: float = 1e-6):
    """The mixer on one token h (B, 1, D) from the SSM state and the conv
    tail: (out, new state, new tail)."""
    di, H, P, N, conv_dim = _dims(cfg)
    B_ = h.shape[0]
    z, xBC, dt_raw = torch.split(h @ lp.w_in, [di, conv_dim, H], dim=-1)
    window = torch.cat([conv, xBC], dim=1)  # (B, W, conv)
    ct = compute_dtype(window.dtype)
    conv_out = torch.einsum("bwc,wc->bc", window.to(ct), lp.conv_w.to(ct)) + lp.conv_b.to(ct)
    xBC = F.silu(conv_out)[:, None].to(h.dtype)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt, A = _dt_A(lp, dt_raw)
    xh = xs.reshape(B_, 1, H, P)
    y, ssm = ssd_decode(xh, dt, A, Bm, Cm, ssm)
    return _gated_out(lp, y, xh, z, norm_before_gate, eps), ssm, window[:, 1:]


def _dt_A(lp, dt_raw: torch.Tensor):
    """dt = softplus(dt_raw + dt_bias) and A = -exp(A_log) in the widened
    type (float32 for the bf16 and f32 models)."""
    ct = compute_dtype(dt_raw.dtype)
    x = dt_raw.to(ct) + lp.dt_bias.to(ct)
    dt = torch.logaddexp(x, torch.zeros_like(x))  # stable softplus
    return dt, -torch.exp(lp.A_log.to(ct))


def _gated_out(lp, y, xh, z, norm_before_gate: bool, eps: float):
    """y + D x, the gated RMSNorm over all di channels, out_proj. With
    ``norm_before_gate`` (mamba2): RMSNorm(y) * SiLU(z), y rounded to the
    model dtype first; without (granite): RMSNorm(y * SiLU(z)) in the
    scan's float32, then rounded."""
    B_, S = z.shape[:2]
    y = y + lp.D_skip.to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
    if norm_before_gate:
        y = y.reshape(B_, S, -1).to(z.dtype)  # the float32 sum is freed here
        y = rmsnorm(y, lp.norm, eps) * F.silu(z)
    else:
        y = rmsnorm(y.reshape(B_, S, -1) * F.silu(z.to(y.dtype)), lp.norm, eps).to(z.dtype)
    return y @ lp.w_out


class Mamba2(ParamModule):
    """Mamba-2 LM. Its own parameters are the embedding, the final norm and
    the untied head; ``layers`` holds the blocks."""

    def __init__(self, cfg: ModelConfig, device="cuda") -> None:
        cfg.validate()
        dt = cfg.torch_dtype
        D, V = cfg.d_model, cfg.vocab
        spec = {"embed": _normal((V, D), 0.02, dt), "final_norm": _const((D,), 0.0, dt)}
        if not cfg.tie_embeddings:
            spec["lm_head"] = _normal((D, V), 0.02, dt)
        super().__init__(spec, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Mamba2Block(cfg, device) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Mamba2":
        super().init_(generator)
        for blk in self.layers:
            blk.init_(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return hidden @ head

    # ---- training -----------------------------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Hidden states (B, S, D) after the final norm."""
        cfg = self.cfg
        x = self.embed[tokens.long()]
        for lp in self.layers:
            x = maybe_remat(lambda u, lp=lp: _block_seq(cfg, lp, u), cfg.remat)(x)
        return rmsnorm(x, self.final_norm)

    def loss(self, batch: dict) -> Tuple[torch.Tensor, dict]:
        """The reference's loss_fn: mean token NLL (row-weighted when the
        batch has ``loss_weights``); returns (loss, {"nll", "moe_aux"})."""
        logits = self._logits(self.forward(batch["tokens"]))
        loss = lm_loss(logits, batch["labels"], batch.get("loss_weights"))
        return loss, {"nll": loss, "moe_aux": torch.zeros((), dtype=torch.float32, device=loss.device)}

    # ---- serving ------------------------------------------------------------

    def init_cache(self, B: int, seq_len: int) -> dict:
        """SSM state + conv tail: O(1) in seq_len."""
        cfg = self.cfg
        di, H, P, N, conv_dim = _dims(cfg)
        L, W, dev = cfg.n_layers, cfg.conv_width, self.device
        return {
            "ssm": torch.zeros((L, B, H, P, N), dtype=torch.float32, device=dev),
            "conv": torch.zeros((L, B, W - 1, conv_dim), dtype=cfg.torch_dtype, device=dev),
            "len": 0,
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, extra_slots: int = 0) -> Tuple[torch.Tensor, dict]:
        """Prompt pass (B, S): the last position's logits (B, 1, V) and the
        recurrent state cache (``extra_slots`` is accepted for API
        uniformity; the state is O(1))."""
        cfg = self.cfg
        B_, S = tokens.shape
        x = self.embed[tokens.long()]
        cache = self.init_cache(B_, S)
        for l, lp in enumerate(self.layers):
            y, cache["ssm"][l], cache["conv"][l] = ssm_mixer_prefill(cfg, lp, rmsnorm(x, lp.ln))
            x = x + y
        x = rmsnorm(x, self.final_norm)
        cache["len"] = S
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step (token (B, 1)); updates the cache in place.
        Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        x = self.embed[token.long()]  # (B, 1, D)
        for l, lp in enumerate(self.layers):
            y, cache["ssm"][l], cache["conv"][l] = ssm_mixer_step(
                cfg, lp, rmsnorm(x, lp.ln), cache["ssm"][l], cache["conv"][l])
            x = x + y
        x = rmsnorm(x, self.final_norm)
        cache["len"] += 1
        return self._logits(x), cache
