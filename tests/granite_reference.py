"""Plain float32 reference of the granite family (IBM Granite 4.0 hybrids,
HF ``GraniteMoeHybridForCausalLM`` with no experts), for the port's CPU
tests. Plain ``torch``: nothing of the port, no kernel, no JAX.

It follows the published equations (hf:ibm-granite/granite-4.0-h-micro,
``modeling_granitemoehybrid.py``)::

    h = embedding_multiplier * E[tokens]
    for each layer l:
        h = h + residual_multiplier * mixer_l(RMSNorm(h))
        x = RMSNorm(h)
        h = h + residual_multiplier * W_down(SiLU(x W_gate) * (x W_up))
    logits = RMSNorm(h) E^T / logits_scaling

with ``mixer_l`` a Mamba-2 mixer (in-projection to z, x, B, C, dt; causal
depthwise convolution of (x, B, C) with bias, SiLU; dt = softplus(dt +
dt_bias), A = -exp(A_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1} +
dt_t x_t B_t^T, y_t = h_t C_t + D x_t, taken step by step; the gated norm
RMSNorm(y * SiLU(z)) over all d_inner channels; out-projection) or causal
grouped-query attention with no position embedding and softmax scale
``attention_multiplier`` (query head i reads key/value head i // (H / KV)).

Departures from the published code, none of which changes the function:

- every RMSNorm scales by ``(1 + w)`` with w stored as an offset from 1
  (the port's parametrisation; HF stores the scale itself);
- weights are stored ``(in, out)`` and applied as ``x @ W``; HF's
  ``input_linear`` of the MLP, whose halves are gate then up, is stored
  as ``w_gate`` and ``w_up``; the convolution's weight is ``(W, C)``;
- the SSD is the sequential recurrence, not the chunked algorithm.

``params`` use the port's names (``embed``, ``final_norm``,
``layers.<l>.<name>``); ``cfg`` is the port's config as a dict. The
computation runs in the dtype of ``params``: float32 for the reference,
bfloat16 to show the tests' tolerances refuse a lower precision.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["logits", "loss", "clip_and_adam"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1 + w)


def _mamba(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, S, D = h.shape
    di = cfg["ssm_expand"] * D
    H, P, N = cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["ssm_state"]
    z, xBC, dt = torch.split(h @ p["w_in"], [di, di + 2 * N, H], dim=-1)
    W = p["conv_w"].shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    xBC = sum(pad[:, j:j + S] * p["conv_w"][j] for j in range(W)) + p["conv_b"]
    x, Bm, Cm = torch.split(F.silu(xBC), [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(h.dtype))
    A = -torch.exp(p["A_log"].to(h.dtype))
    x = x.reshape(b, S, H, P)
    state = h.new_zeros((b, H, P, N))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        state = decay * state + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append((state * Cm[:, t, None, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + p["D_skip"].to(h.dtype)[:, None] * x
    y = _rms(y.reshape(b, S, di) * F.silu(z), p["norm"], cfg["norm_eps"])
    return y @ p["w_out"]


def _attention(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, S, _ = h.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = (h @ p["wq"]).reshape(b, S, H, hd).transpose(1, 2)
    k = (h @ p["wk"]).reshape(b, S, KV, hd).transpose(1, 2).repeat_interleave(H // KV, dim=1)
    v = (h @ p["wv"]).reshape(b, S, KV, hd).transpose(1, 2).repeat_interleave(H // KV, dim=1)
    s = (q @ k.transpose(-1, -2)) * cfg["attention_multiplier"]
    causal = torch.ones((S, S), dtype=torch.bool).tril()
    o = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
    return o.transpose(1, 2).reshape(b, S, H * hd) @ p["wo"]


def logits(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, S, V) logits of ``tokens`` (B, S)."""
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    h = params["embed"][tokens.long()] * cfg["embedding_multiplier"]
    for l, kind in enumerate(cfg["layer_types"]):
        p = {k.split(".", 2)[2]: v for k, v in params.items() if k.startswith(f"layers.{l}.")}
        mixer = _mamba if kind == "mamba" else _attention
        h = h + r * mixer(p, _rms(h, p["ln"], eps), cfg)
        x = _rms(h, p["ln2"], eps)
        h = h + r * ((F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"])
    head = params["embed"].T if cfg["tie_embeddings"] else params["lm_head"]
    return (_rms(h, params["final_norm"], eps) @ head) / cfg["logits_scaling"]


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
         cfg: dict, row_weights=None) -> torch.Tensor:
    """Mean next-token NLL over every position, or with ``row_weights``
    sum_r w_r (row r's mean NLL)."""
    z = logits(params, tokens, cfg)
    nll = torch.logsumexp(z, -1) - torch.gather(z, -1, labels.long()[..., None])[..., 0]
    if row_weights is None:
        return nll.mean()
    return (row_weights * nll.mean(-1)).sum()


@torch.no_grad()
def clip_and_adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float,
                  max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """The first Adam step (Kingma & Ba, bias-corrected, from zero moments)
    after clipping the gradients at a global norm: new parameters."""
    gn = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / gn, max=1.0)
    out = {}
    for n, p in params.items():
        g = grads[n] * scale
        m, v = (1 - b1) * g / (1 - b1), (1 - b2) * g * g / (1 - b2)
        out[n] = p - lr * m / (torch.sqrt(v) + eps)
    return out
