"""SGD / Adam over a dict of parameters (port of `repro.optim.sgd`).

Plain functions with the reference's step algebra: gradients are widened
to float32, Adam keeps float32 moments whatever the parameter's dtype
(``torch.optim.Adam`` would keep them in the parameter's dtype, bf16 for
the LM), the step's bias corrections are float32, and each new parameter
is rounded once to its dtype. Inputs are dicts name -> tensor.
``clip_by_global_norm_`` and ``adam_update_`` update in place, leaf by
leaf, which the training runtime needs: a full-size model cannot hold a
second copy of its parameters and float32 moments for the step
(recurrentgemma-9b's 256,000-token embedding and head alone are 2.1 B
parameters). ``clip_by_global_norm`` and ``adam_update`` are the same
arithmetic on copies, returning new tensors as the reference's do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "sgd_update",
    "adam_init",
    "adam_update",
    "adam_update_",
    "clip_by_global_norm",
    "clip_by_global_norm_",
]

Tensors = Dict[str, torch.Tensor]


def _copy(tensors: Tensors) -> Tensors:
    return {k: t.clone() for k, t in tensors.items()}


@torch.no_grad()
def clip_by_global_norm_(grads: Tensors, max_norm: float) -> torch.Tensor:
    """Scale every gradient in place by min(1, max_norm / ||g||) with the
    global norm taken in float32; returns the norm."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    limit = torch.tensor(max_norm, dtype=torch.float32, device=gn.device)
    scale = torch.clamp(limit / torch.clamp(gn, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_((g.float() * scale).to(g.dtype))
    return gn


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """``clip_by_global_norm_`` on copies; returns (grads, norm)."""
    out = _copy(grads)
    return out, clip_by_global_norm_(out, max_norm)


def sgd_update(params: Tensors, grads: Tensors, lr) -> Tensors:
    return {k: (p.float() - lr * grads[k].float()).to(p.dtype) for k, p in params.items()}


def adam_init(params: Tensors) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "t": 0,
    }


def adam_update(
    params: Tensors,
    grads: Tensors,
    state: dict,
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[Tensors, dict]:
    """One Adam step on copies (``adam_update_``); returns (new params,
    new state). ``state["t"]`` is a Python int step count."""
    new_p = _copy(params)
    new_state = {"m": _copy(state["m"]), "v": _copy(state["v"]), "t": state["t"]}
    return new_p, adam_update_(new_p, grads, new_state, lr, b1, b2, eps, weight_decay)


def _bias_corrections(t: int, b1: float, b2: float):
    """1 - b^t in float32, as the reference computes it."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf)
    return bc1, bc2


@torch.no_grad()
def adam_update_(
    params: Tensors,
    grads: Tensors,
    state: dict,
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> dict:
    """One Adam step in place, leaf by leaf: float32 moments, float32 bias
    corrections, each new parameter rounded once to its dtype; returns
    ``state`` with its step count advanced."""
    t = state["t"] + 1
    bc1, bc2 = _bias_corrections(t, b1, b2)
    for k, p in params.items():
        g32 = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        del g32
        step = (m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device)) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    state["t"] = t
    return state
