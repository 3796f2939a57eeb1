"""Shared neural layers (port of `repro.models.layers`).

Plain PyTorch functions over tensors, with the reference's shape
conventions:

  B batch, S sequence, D d_model, H query heads, KV kv heads, hd head_dim,
  F d_ff, W attention window.

and its numerics: norms, RoPE and attention compute in float32
(`repro_torch.kernels.ref.compute_dtype`, float64 for float64 inputs) and
cast back, masked scores take ``NEG_INF = -1e30``, attention scores and
softmax run in float32, and decode attention rounds the scaled query and the
probabilities to the cache's storage dtype before float32-accumulated
products. Weights are stored ``(in, out)`` and applied as ``x @ W``.

The flash-attention kernel lives in `repro_torch.kernels`; the functions
here are the plain paths (``attn_impl="plain"``) and decode, which no
kernel serves. ``causal_conv``, the plain form a kernel is held to, lives
in `repro_torch.kernels.ref` and is named here too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ref import causal_conv, compute_dtype

__all__ = [
    "NEG_INF",
    "ParamModule",
    "rmsnorm",
    "layernorm",
    "rope_frequencies",
    "apply_rope",
    "_expand_kv",
    "naive_attention",
    "blocked_attention",
    "decode_attention",
    "mlp_apply",
    "moe_capacity",
    "moe_route",
    "moe_slots",
    "moe_apply",
    "causal_conv",
    "maybe_remat",
]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

# name -> (shape, "normal" | "const", scale or value, dtype)
Spec = Dict[str, Tuple[tuple, str, float, torch.dtype]]


def _normal(shape, scale: float, dt: torch.dtype):
    return (tuple(shape), "normal", scale, dt)


def _const(shape, value: float, dt: torch.dtype):
    return (tuple(shape), "const", value, dt)


class ParamModule(nn.Module):
    """A module whose parameters are declared by shape and init rule.

    Parameters are created empty on ``device`` without a gradient (serving;
    a trainer turns gradients on with ``requires_grad_(True)``) and filled
    by ``init_`` one tensor at a time, drawn in
    float32 on the device and then cast, so a 10 B-parameter model never
    holds a float32 copy of more than one tensor. The draws follow the
    reference's scales, not its random bits."""

    def __init__(self, spec: Spec, device) -> None:
        super().__init__()
        self._spec = spec
        for name, (shape, _, _, dtype) in spec.items():
            self.register_parameter(
                name,
                nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device),
                    requires_grad=False,
                ),
            )

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "ParamModule":
        for name, (shape, kind, value, _) in self._spec.items():
            p = getattr(self, name)
            if kind == "normal":
                w = torch.randn(
                    shape, generator=generator, dtype=torch.float32, device=p.device
                )
                p.copy_(w.mul_(value))
            else:
                p.fill_(value)
        return self


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(compute_dtype(dt))
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(x.dtype))).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.to(compute_dtype(dt))
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(x.dtype) + bias.to(x.dtype)).to(dt)


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------


def rope_frequencies(
    rot_dim: int, theta: float, positions: torch.Tensor, dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables in ``dtype``. positions: (..., S) int -> (..., S, rot_dim/2)."""
    exps = torch.arange(0, rot_dim, 2, dtype=dtype, device=positions.device)
    inv = 1.0 / (theta ** (exps / rot_dim))
    ang = positions.to(dtype)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, hd)
    positions: torch.Tensor,  # (B, S) or (3, B, S) for M-RoPE
    theta: float,
    fraction: float = 1.0,
    mrope_sections: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ct = compute_dtype(x.dtype)

    if mrope_sections is not None:
        # Qwen2-VL M-RoPE: the rot/2 frequency slots are split into three
        # sections driven by (temporal, height, width) position ids.
        sec = tuple(mrope_sections)
        if sum(sec) != rot // 2:
            raise ValueError(f"mrope sections {sec} do not sum to {rot // 2}")
        cos3, sin3 = rope_frequencies(rot, theta, positions, ct)  # (3,B,S,rot/2)
        cos = torch.cat([torch.split(cos3[i], sec, dim=-1)[i] for i in range(3)], dim=-1)
        sin = torch.cat([torch.split(sin3[i], sec, dim=-1)[i] for i in range(3)], dim=-1)
    else:
        cos, sin = rope_frequencies(rot, theta, positions, ct)  # (B,S,rot/2)

    cos = cos[..., None, :]  # (B, S, 1, rot/2)
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x_rot.to(ct), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.cat([y1, y2], dim=-1).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if rot < hd else y


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*q_per_kv, hd) by repeat (GQA): query head
    h reads kv head h // q_per_kv."""
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _scale(hd: int, dtype: torch.dtype = torch.float32) -> float:
    """1/sqrt(hd) rounded to ``dtype`` (float32, as the reference computes
    it, unless the layers compute in float64)."""
    one = torch.tensor(1.0, dtype=dtype)
    return float(one / torch.sqrt(torch.tensor(float(hd), dtype=dtype)))


def _band(qpos, kpos, causal: bool, window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def naive_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, H, hd)  (already GQA-expanded)
    v: torch.Tensor,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-matrix attention (short sequences)."""
    Sq, hd = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    ct = compute_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * _scale(hd, ct)
    dev = q.device
    qpos = torch.arange(Sq, device=dev) + q_offset
    kpos = torch.arange(Skv, device=dev)
    mask = _band(qpos, kpos, causal, window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct))
    return out.to(q.dtype)


def blocked_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, H, hd)  (already GQA-expanded)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 512,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention block by block (O(S * block) memory).

    Like the reference, every block is computed (masked), including those
    wholly outside the causal/window band."""
    B, S, H, hd = q.shape
    if S % block_q or S % block_kv:
        raise ValueError(f"S={S} is not a multiple of blocks {block_q}/{block_kv}")
    nq, nk = S // block_q, S // block_kv
    ct = compute_dtype(q.dtype)
    scale = _scale(hd, ct)
    dev = q.device
    qb = q.reshape(B, nq, block_q, H, hd).permute(1, 0, 3, 2, 4)  # (nq,B,H,bq,hd)
    kb = k.reshape(B, nk, block_kv, H, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, block_kv, H, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        q32 = qb[qi].to(ct) * scale
        qpos = qi * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros((B, H, block_q, hd), dtype=ct, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=ct, device=dev)
        l = torch.zeros((B, H, block_q), dtype=ct, device=dev)
        for ki in range(nk):
            kpos = ki * block_kv + torch.arange(block_kv, device=dev)
            s = torch.einsum("bhqd,bhkd->bhqk", q32, kb[ki].to(ct))
            s = torch.where(_band(qpos, kpos, causal, window)[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vb[ki].to(ct)
            )
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs)  # (nq, B, H, bq, hd)
    out = out.permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, C, KV, hd) — C = cache length (maybe ring)
    v_cache: torch.Tensor,
    valid: torch.Tensor,  # (B, C) bool — which cache slots participate
) -> torch.Tensor:
    """Single-token decode attention over a (possibly ring-buffered) cache.

    The reference's numerics: the scaled query and the probabilities are
    rounded to the cache's storage dtype, the products accumulate in
    float32. A product of two bf16 values is exact in float32, so the
    cache is widened to float32 for the products (one copy per layer and
    step; exact, not cheap — decode is plain PyTorch in this port)."""
    B, C, KV, hd = k_cache.shape
    H = q.shape[2]
    # Heads are group-major: q head h belongs to kv head h // (H/KV).
    qg = q[:, 0].reshape(B, KV, H // KV, hd)  # (B, KV, qpk, hd)
    qs = (qg.float() * _scale(hd)).to(k_cache.dtype)
    s = torch.einsum("bgqd,bcgd->bgqc", qs.float(), k_cache.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum(
        "bgqc,bcgd->bgqd", p.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(x: torch.Tensor, p, act: str) -> torch.Tensor:
    """Gated or plain MLP. ``p`` holds w_gate/w_up/w_down (gated) or
    w_in/w_out as attributes."""
    if act in ("swiglu", "geglu"):
        g = x @ p.w_gate
        u = x @ p.w_up
        h = (F.silu(g) if act == "swiglu" else gelu(g)) * u
        return h @ p.w_down
    h = gelu(x @ p.w_in)
    return h @ p.w_out


# --------------------------------------------------------------------------
# Mixture of Experts (capacity-based dispatch)
# --------------------------------------------------------------------------


def moe_capacity(tokens_per_group: int, capacity_factor: float, top_k: int, n_experts: int) -> int:
    """Slots per expert and group: int(max(1, factor * Tg * k / E)),
    at most Tg (the reference's arithmetic, in Python floats)."""
    C = int(max(1, capacity_factor * tokens_per_group * top_k / n_experts))
    return min(C, tokens_per_group)


def moe_route(xg: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router of ``moe_apply``: (probs (G, Tg, E), gate values (G, Tg, k)
    before renormalisation, expert indices (G, Tg, k)), in ``compute_dtype``
    precision (float32 for bf16 and f32 inputs). Top-k by a stable
    descending sort: on equal probabilities the lower expert index comes
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order for ties). The gate values are gathered from ``probs``, so
    their gradient reaches the selected probabilities only."""
    ct = compute_dtype(xg.dtype)
    logits = torch.einsum("gtd,de->gte", xg.to(ct), router.to(ct))
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]
    return probs, torch.gather(probs, -1, idx), idx


def moe_slots(gate_idx: torch.Tensor, capacity: int, n_experts: int):
    """Each slot's place in its expert's buffer, per group: (expert
    (G, Tg k), position (G, Tg k), keep (G, Tg k)), slots in token-major,
    choice-minor order. A slot's position is the number of earlier slots
    of its group routed to the same expert (an exclusive cumsum of the
    one-hot assignment); slots at positions >= ``capacity`` are dropped.
    The count runs along the innermost dimension of an expert-major
    (G, E, Tg k) one-hot: a scan along an outer dimension only E wide
    took 2.9 ms a layer of phi3.5-moe's prefill on an H100 (PERF.md)."""
    G = gate_idx.shape[0]
    flat_e = gate_idx.reshape(G, -1)
    onehot = F.one_hot(flat_e, n_experts).transpose(1, 2).contiguous()  # (G, E, Tg k)
    pos_in_e = torch.cumsum(onehot, dim=-1) - onehot
    pos = torch.gather(pos_in_e, 1, flat_e[:, None, :])[:, 0]
    return flat_e, pos, pos < capacity


def moe_apply(
    x: torch.Tensor,  # (T, D) flattened tokens
    p,  # router (D, E), w_gate/w_up (E, D, F), w_down (E, F, D) as attributes
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    act: str = "swiglu",
    groups: int = 1,
    shard_axis: str = "",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing with per-expert capacity (the reference's
    ``moe_apply``). Returns (out (T, D) in x's dtype, the load-balance
    aux loss, a scalar in ``compute_dtype`` precision).

    Tokens split into ``groups`` groups of Tg = T / G, each with its own
    capacity C = ``moe_capacity(Tg, ...)`` per expert. A slot (token,
    choice) takes position ``pos`` in its expert's buffer, the count of
    earlier slots to that expert in token-major, choice-minor order; slots
    at ``pos >= C`` are dropped, so the token keeps only its residual for
    that choice. Dispatch scatters into a fixed (G, E, C, D) buffer
    (dropped slots add zeros at (0, C - 1)); the expert products run over
    (E, G C, D); combine gathers each slot's output, weights it by its
    renormalised gate and sums a token's k slots. Shapes depend on T, E,
    k and C only, so nothing waits on the host.

    The aux loss is Switch's E sum_e f_e m_e, f_e the share of tokens
    whose first choice is e and m_e the mean router probability.

    ``shard_axis`` pins the reference's XLA layouts on a mesh and changes
    no number; it is accepted and ignored here."""
    del shard_axis
    T, D = x.shape
    E, k, G = n_experts, top_k, groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = moe_capacity(Tg, capacity_factor, k, E)
    xg = x.reshape(G, Tg, D)

    probs, gate_vals, gate_idx = moe_route(xg, p.router, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(gate_idx[..., 0], E).to(probs.dtype).mean(dim=(0, 1))
    aux = E * (fe * me).sum()

    flat_e, pos, keep = moe_slots(gate_idx, C, E)
    e_safe = torch.where(keep, flat_e, 0)
    p_safe = torch.where(keep, pos, C - 1)
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    tok_idx = torch.arange(Tg * k, device=x.device) // k
    vals = torch.where(keep[..., None], xg[:, tok_idx], 0).to(x.dtype)
    buf = x.new_zeros((G, E, C, D)).index_put((g_idx, e_safe, p_safe), vals, accumulate=True)

    he = buf.transpose(0, 1).reshape(E, G * C, D)
    g = he @ p.w_gate
    u = he @ p.w_up
    h = (F.silu(g) if act == "swiglu" else gelu(g)) * u
    y = (h @ p.w_down).reshape(E, G, C, D).transpose(0, 1)  # (G, E, C, D)

    slot_out = torch.where(keep[..., None], y[g_idx, e_safe, p_safe], 0)
    w = gate_vals.reshape(G, Tg * k, 1).to(slot_out.dtype)
    out = (slot_out * w).reshape(G, Tg, k, D).sum(dim=2)
    return out.reshape(T, D).to(x.dtype), aux


# --------------------------------------------------------------------------
# Rematerialisation
# --------------------------------------------------------------------------


def _save_products(ctx, func, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of 2-d matrix products
    (``x @ W`` on an (B, S, D) activation reaches ``aten.mm``), recompute
    everything else, batched products (``bmm``) and the kernels' launches
    included."""
    from torch.utils.checkpoint import CheckpointPolicy

    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn, remat: str):
    """Wrap a per-layer function in activation checkpointing per the
    config policy (the reference's ``jax.checkpoint`` of the layer scan).

    "none" keeps every activation; "full" keeps only the layer's inputs
    and recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); "dots" keeps the outputs
    of the matrix products without batch dimensions and recomputes the
    rest (selective checkpointing with `_save_products`, the counterpart
    of ``dots_with_no_batch_dims_saveable``). The reference's kernels are
    not dots, so their outputs are recomputed under "dots" as under
    "full".
    """
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    from functools import partial

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kwargs = {}
    if remat == "dots":
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, _save_products)

    def remat_fn(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)

    return remat_fn
