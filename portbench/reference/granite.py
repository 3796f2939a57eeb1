"""Plain float32 reference of the ``granite`` family: IBM Granite 4.0
hybrids without experts (HF ``granitemoehybrid``,
hf:ibm-granite/granite-4.0-h-micro's widths in the benchmark's
configuration), with the repo's parameter layout.

    h = embedding_multiplier * E[tokens]
    for each layer l:
        h = h + residual_multiplier * mixer_l(RMSNorm(h))
        x = RMSNorm(h)
        h = h + residual_multiplier * W_down(SiLU(x W_gate) * (x W_up))
    logits = RMSNorm(h) E^T / logits_scaling

``mixer_l`` is ``layer_types[l]``: a Mamba-2 mixer (in-projection to z,
x, B, C, dt; causal depthwise convolution of (x, B, C) with bias, SiLU;
dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD scan of
`reference.ssm.ssd` plus D x; the gated norm RMSNorm(y * SiLU(z)) over
all d_inner channels, gate before the norm; out-projection) or causal
grouped-query attention with no position embedding (query head i reads
key/value head i // (H / KV)), softmax scale ``attention_multiplier``.
Every RMSNorm takes ``norm_eps`` and scales by (1 + w) (the repo's
parametrisation; HF stores the scale itself). HF's ``input_linear`` of
the MLP (gate, then up) is held as ``w_gate`` and ``w_up``.

Each layer is recomputed in the backward pass (``checkpoint``), each
row's attention block by block of queries, and the head with the loss
in blocks of positions of one row, so that the reference fits beside its
inputs at the timed sizes (2 rows of 8,192: a row's scores of one head
over all keys, or its logits over the 100,352-token vocabulary, would
take gigabytes at once).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import const, mm, normal, rmsnorm, row_nll
from .ssm import ssd

__all__ = ["SMOKE", "SMOKE_SEQ", "param_spec", "active_params", "attention_flops", "loss"]

# The family's model at a size the CPU tests hold (`portbench.smoke`): two
# periods of (Mamba, attention), the published scalars; rows a multiple of
# ``ssm_chunk``.
SMOKE = dict(family="granite", n_layers=4, d_model=128, vocab=512, n_heads=4, n_kv_heads=2,
             head_dim=64, d_ff=256, ssm_state=16, ssm_heads=8, ssm_head_dim=32,
             ssm_expand=2, ssm_chunk=32, conv_width=4,
             layer_types=["mamba", "attention", "mamba", "attention"],
             embedding_multiplier=12.0, residual_multiplier=0.22,
             attention_multiplier=0.015625, logits_scaling=8.0, norm_eps=1e-5,
             position_embedding_type="nope", mlp_act="swiglu", tie_embeddings=True,
             dtype="float32", remat="full")
SMOKE_SEQ = 64

_Q_BLOCK = 1024  # query positions of one row's attention at a time
_HEAD_BLOCK = 2048  # positions of one row's logits at a time


def _dims(m: dict):
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], di + 2 * m["ssm_state"]


def param_spec(m: dict) -> Dict[str, tuple]:
    """name -> (shape, init rule, dtype) in the program's parameter names."""
    D, V, L, W, F_ = m["d_model"], m["vocab"], m["n_layers"], m["conv_width"], m["d_ff"]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    di, Hs, P, N, conv_dim = _dims(m)
    out = 0.02 / max(L, 1) ** 0.5
    spec = {"embed": normal((V, D), 0.02), "final_norm": const((D,), 0.0)}
    if not m["tie_embeddings"]:
        spec["lm_head"] = normal((D, V), 0.02)
    for l, kind in enumerate(m["layer_types"]):
        p = f"layers.{l}."
        spec[p + "ln"] = const((D,), 0.0)
        if kind == "mamba":
            spec.update({
                p + "w_in": normal((D, 2 * di + 2 * N + Hs), 0.02),
                p + "conv_w": normal((W, conv_dim), 0.2),
                p + "conv_b": const((conv_dim,), 0.0),
                p + "A_log": ((Hs,), ("log_linspace", 1.0, 16.0), "float32"),
                p + "dt_bias": const((Hs,), 0.0, "float32"),
                p + "D_skip": const((Hs,), 1.0, "float32"),
                p + "norm": const((di,), 0.0),
                p + "w_out": normal((di, D), out),
            })
        else:
            spec.update({
                p + "wq": normal((D, H * hd), 0.02),
                p + "wk": normal((D, KV * hd), 0.02),
                p + "wv": normal((D, KV * hd), 0.02),
                p + "wo": normal((H * hd, D), out),
            })
        spec.update({
            p + "ln2": const((D,), 0.0),
            p + "w_gate": normal((D, F_), 0.02),
            p + "w_up": normal((D, F_), 0.02),
            p + "w_down": normal((F_, D), out),
        })
    return spec


def active_params(m: dict) -> int:
    """Parameters that multiply a token: each Mamba mixer's projections and
    convolution, each attention mixer's projections, each MLP, and the
    head (the tied embedding, as a product)."""
    D, V, W, F_ = m["d_model"], m["vocab"], m["conv_width"], m["d_ff"]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    di, Hs, P, N, conv_dim = _dims(m)
    mixer = {"mamba": D * (2 * di + 2 * N + Hs) + W * conv_dim + di * D,
             "attention": 2 * D * H * hd + 2 * D * KV * hd}
    return sum(mixer[t] + 3 * D * F_ for t in m["layer_types"]) + D * V


def attention_flops(m: dict, seq: int) -> int:
    """Forward flops of one row's scores and value products over the
    causal pairs: 4 hd per (query, key) pair and head, each attention
    layer. The SSD's own products are not counted (under 0.5% of the
    projections', as in the ssm family)."""
    pairs = seq * (seq + 1) // 2
    n_attn = m["layer_types"].count("attention")
    return n_attn * m["n_heads"] * 4 * m["head_dim"] * pairs


def _mamba(m, precision, h, w_in, conv_w, conv_b, A_log, dt_bias, D_skip, norm, w_out):
    di, H, P, N, conv_dim = _dims(m)
    b, S, _ = h.shape
    z, xBC, dt_raw = torch.split(mm(h, w_in, precision), [di, conv_dim, H], dim=-1)
    W = conv_w.shape[0]
    xBC = F.conv1d(F.pad(xBC.transpose(1, 2), (W - 1, 0)), conv_w.T[:, None, :],
                   conv_b, groups=conv_dim).transpose(1, 2)
    x, Bm, Cm = torch.split(F.silu(xBC), [di, N, N], dim=-1)
    dt = F.softplus(dt_raw + dt_bias)
    xh = x.reshape(b, S, H, P)
    y = ssd(xh, dt, -torch.exp(A_log), Bm, Cm, m["ssm_chunk"])
    y = (y + D_skip[None, None, :, None] * xh).reshape(b, S, di)
    return mm(rmsnorm(y * F.silu(z), norm, m["norm_eps"]), w_out, precision)


def _attention_block(m, precision, q, k, v, start: int):
    """Queries ``start`` on of one row, q (H, Lq, hd), against the keys up
    to the block's last query, k/v (H, start + Lq, hd): (Lq, H * hd)."""
    H, Lq, hd = q.shape
    s = mm(q, k.transpose(1, 2), precision) * m["attention_multiplier"]
    qpos = start + torch.arange(Lq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    p = torch.softmax(s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf")), dim=-1)
    return mm(p, v, precision).transpose(0, 1).reshape(Lq, H * hd)


def _attention(m, precision, h, wq, wk, wv, wo):
    b, S, _ = h.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(h, wq, precision).reshape(b, S, H, hd).transpose(1, 2)
    k = mm(h, wk, precision).reshape(b, S, KV, hd).transpose(1, 2)
    v = mm(h, wv, precision).reshape(b, S, KV, hd).transpose(1, 2)
    k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    rows = []
    for r in range(b):
        blocks = [checkpoint(_attention_block, m, precision, q[r, :, s:s + _Q_BLOCK],
                             k[r, :, :s + _Q_BLOCK], v[r, :, :s + _Q_BLOCK], s,
                             use_reentrant=False) for s in range(0, S, _Q_BLOCK)]
        rows.append(torch.cat(blocks))
    return mm(torch.stack(rows), wo, precision)


_MAMBA_KEYS = ("w_in", "conv_w", "conv_b", "A_log", "dt_bias", "D_skip", "norm", "w_out")
_ATTN_KEYS = ("wq", "wk", "wv", "wo")


def _layer(m, precision, kind, x, ln, ln2, w_gate, w_up, w_down, *mixer):
    eps, r = m["norm_eps"], m["residual_multiplier"]
    mix = _mamba if kind == "mamba" else _attention
    x = x + r * mix(m, precision, rmsnorm(x, ln, eps), *mixer)
    h = rmsnorm(x, ln2, eps)
    mlp = mm(F.silu(mm(h, w_gate, precision)) * mm(h, w_up, precision), w_down, precision)
    return x + r * mlp


def _head_loss(m, precision, x, final_norm, head, labels, weight, S: int):
    """A block of positions of one row: its share of w_r * (row's mean NLL)."""
    logits = mm(rmsnorm(x, final_norm, m["norm_eps"]), head, precision) / m["logits_scaling"]
    return weight * row_nll(logits, labels).sum() * (labels.shape[-1] / S)


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
         row_weights: torch.Tensor, m: dict, precision: str = "float32"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total loss, nll): sum_r w_r * (row r's mean token NLL), float32.
    ``params`` are float32 tensors under the program's names."""
    x = params["embed"][tokens.long()] * m["embedding_multiplier"]
    for l, kind in enumerate(m["layer_types"]):
        keys = ("ln", "ln2", "w_gate", "w_up", "w_down",
                *(_MAMBA_KEYS if kind == "mamba" else _ATTN_KEYS))
        lp = [params[f"layers.{l}.{k}"] for k in keys]
        x = checkpoint(_layer, m, precision, kind, x, *lp, use_reentrant=False)
    head = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    S = tokens.shape[1]
    nll = x.new_zeros(())
    for r in range(tokens.shape[0]):
        for s in range(0, S, _HEAD_BLOCK):
            nll = nll + checkpoint(_head_loss, m, precision, x[r:r + 1, s:s + _HEAD_BLOCK],
                                   params["final_norm"], head,
                                   labels[r:r + 1, s:s + _HEAD_BLOCK], row_weights[r], S,
                                   use_reentrant=False)
    return nll, nll
