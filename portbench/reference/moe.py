"""Plain float32 reference of the ``moe`` family: a decoder-only
transformer whose every layer is attention + a routed mixture of experts,
with the repo's parameter layout (hf:microsoft/Phi-3.5-MoE-instruct's
widths in the benchmark's configuration).

Layer, pre-norm residual: RMSNorm -> q, k, v projections (grouped-query:
query head i reads key/value head i // (H / KV)) -> rotary embedding over
the whole head (halves rotated, base ``rope_theta``) -> causal softmax
attention in float32 -> out-projection; RMSNorm -> routed experts.

Experts, token-choice top-k with per-expert capacity, one group: router
softmax in float32; the k largest probabilities, ties to the lower expert;
gates renormalised to sum 1. Slots run token-major, choice-minor; an
expert keeps its first C = min(int(max(1, factor * T * k / E)), T) slots
and drops the rest (a dropped slot adds nothing). Each expert's SwiGLU
runs on the tokens it kept, and each kept slot adds its output times its
gate. The load-balance term is E * sum_e f_e m_e (f_e: share of tokens
whose first choice is e; m_e: mean router probability), summed over the
layers and added to the NLL times ``router_aux_weight``. Each layer, each
row's attention and each row's head with loss are recomputed in the
backward pass (``checkpoint``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import const, mm, normal, rmsnorm, row_nll

__all__ = ["SMOKE", "SMOKE_SEQ", "param_spec", "active_params", "attention_flops", "loss"]

# The family's model at a size the CPU tests hold (`portbench.smoke`), and
# the length of its rows there.
SMOKE = dict(family="moe", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=128, vocab=512, n_experts=4, experts_per_token=2, capacity_factor=1.25,
             router_aux_weight=0.01, moe_groups=1, rope_theta=10000.0, mlp_act="swiglu",
             norm="rmsnorm", tie_embeddings=False, dtype="float32", remat="full")
SMOKE_SEQ = 64


def param_spec(m: dict) -> Dict[str, tuple]:
    """name -> (shape, init rule, dtype) in the program's parameter names."""
    D, V, L, F_ = m["d_model"], m["vocab"], m["n_layers"], m["d_ff"]
    H, KV, hd, E = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["n_experts"]
    out = 0.02 / max(L, 1) ** 0.5
    spec = {"embed": normal((V, D), 0.02), "final_norm": const((D,), 0.0)}
    if not m["tie_embeddings"]:
        spec["lm_head"] = normal((D, V), 0.02)
    for l in range(L):
        p = f"layers.{l}."
        spec.update({
            p + "ln1": const((D,), 0.0),
            p + "ln2": const((D,), 0.0),
            p + "wq": normal((D, H * hd), 0.02),
            p + "wk": normal((D, KV * hd), 0.02),
            p + "wv": normal((D, KV * hd), 0.02),
            p + "wo": normal((H * hd, D), out),
            p + "router": normal((D, E), 0.02),
            p + "w_gate": normal((E, D, F_), 0.02),
            p + "w_up": normal((E, D, F_), 0.02),
            p + "w_down": normal((E, F_, D), out),
        })
    return spec


def active_params(m: dict) -> int:
    """Parameters that multiply a token: attention's projections, the
    router, k of the E experts, and the head (the input embedding is a
    lookup and is not counted)."""
    D, V, L, F_ = m["d_model"], m["vocab"], m["n_layers"], m["d_ff"]
    H, KV, hd, E = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["n_experts"]
    attn = 2 * D * H * hd + 2 * D * KV * hd
    experts = m["experts_per_token"] * 3 * D * F_
    return L * (attn + D * E + experts) + D * V


def attention_flops(m: dict, seq: int) -> int:
    """Forward flops of one row's scores and value products over the
    causal pairs: 4 hd per (query, key) pair and head, every layer."""
    pairs = seq * (seq + 1) // 2
    return m["n_layers"] * m["n_heads"] * 4 * m["head_dim"] * pairs


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, S, heads, hd) rotated by position: halves (x1, x2) ->
    (x1 cos - x2 sin, x2 cos + x1 sin), frequencies theta^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=x.dtype, device=x.device) / hd)
    ang = torch.arange(S, dtype=x.dtype, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention_row(m, precision, q, k, v):
    """One row: q (1, S, H, hd), k/v (1, S, KV, hd) -> (1, S, H * hd)."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    S = q.shape[1]
    qh = q[0].transpose(0, 1)  # (H, S, hd)
    kh = k[0].transpose(0, 1).repeat_interleave(H // KV, dim=0)
    vh = v[0].transpose(0, 1).repeat_interleave(H // KV, dim=0)
    s = mm(qh, kh.transpose(1, 2), precision) * (1.0 / hd ** 0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(p, vh, precision).transpose(0, 1).reshape(1, S, H * hd)


def _experts(m, precision, h, router, w_gate, w_up, w_down):
    """h (T, D) -> (out (T, D), load-balance term)."""
    T = h.shape[0]
    E, k = m["n_experts"], m["experts_per_token"]
    C = min(int(max(1, m["capacity_factor"] * T * k / E)), T)
    probs = torch.softmax(mm(h, router, precision), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    gates = torch.gather(probs, -1, idx)
    gates = (gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)).reshape(-1)
    first = F.one_hot(idx[:, 0], E).to(probs.dtype).mean(dim=0)
    aux = E * (first * probs.mean(dim=0)).sum()
    slot_expert = idx.reshape(-1)  # token-major, choice-minor
    out = torch.zeros_like(h)
    for e in range(E):
        kept = torch.nonzero(slot_expert == e)[:C, 0]
        tok = kept // k
        he = h[tok]
        y = mm(F.silu(mm(he, w_gate[e], precision)) * mm(he, w_up[e], precision),
               w_down[e], precision)
        out = out.index_add(0, tok, y * gates[kept, None])
    return out, aux


def _layer(m, precision, x, ln1, ln2, wq, wk, wv, wo, router, w_gate, w_up, w_down):
    b, S, D = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    h = rmsnorm(x, ln1)
    q = _rope(mm(h, wq, precision).reshape(b, S, H, hd), m["rope_theta"])
    k = _rope(mm(h, wk, precision).reshape(b, S, KV, hd), m["rope_theta"])
    v = mm(h, wv, precision).reshape(b, S, KV, hd)
    o = torch.cat([checkpoint(_attention_row, m, precision, q[r:r + 1], k[r:r + 1],
                              v[r:r + 1], use_reentrant=False) for r in range(b)])
    x = x + mm(o, wo, precision)
    y, aux = _experts(m, precision, rmsnorm(x, ln2).reshape(b * S, D), router, w_gate,
                      w_up, w_down)
    return x + y.reshape(b, S, D), aux


_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down")


def _head_loss(m, precision, x, final_norm, head, labels, weights):
    logits = mm(rmsnorm(x, final_norm), head, precision)
    return (weights * row_nll(logits, labels)).sum()


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
         row_weights: torch.Tensor, m: dict, precision: str = "float32"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total = nll + router_aux_weight * aux, nll), float32; nll is
    sum_r w_r * (row r's mean token NLL). ``params`` are float32 tensors
    under the program's names."""
    if m.get("moe_groups", 1) != 1:
        raise ValueError("the reference routes one group")
    x = params["embed"][tokens.long()]
    aux = x.new_zeros(())
    for l in range(m["n_layers"]):
        lp = [params[f"layers.{l}.{k}"] for k in _LAYER_KEYS]
        x, a = checkpoint(_layer, m, precision, x, *lp, use_reentrant=False)
        aux = aux + a
    head = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    nll = x.new_zeros(())
    for r in range(tokens.shape[0]):
        nll = nll + checkpoint(_head_loss, m, precision, x[r:r + 1], params["final_norm"],
                               head, labels[r:r + 1], row_weights[r:r + 1],
                               use_reentrant=False)
    return nll + m["router_aux_weight"] * aux, nll
