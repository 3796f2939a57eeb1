"""SGD / Adam over a dict of parameters (port of `repro.optim.sgd`).

Plain functions with the reference's step algebra: gradients are widened
to float32, Adam keeps float32 moments whatever the parameter's dtype
(``torch.optim.Adam`` would keep them in the parameter's dtype, bf16 for
the LM), the step's bias corrections are float32, and each new parameter
is rounded once to its dtype. Inputs are dicts name -> tensor; nothing is
updated in place: each returns new tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["sgd_update", "adam_init", "adam_update", "clip_by_global_norm"]

Tensors = Dict[str, torch.Tensor]


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / ||g||) with the global
    norm taken in float32; returns (grads, norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    limit = torch.tensor(max_norm, dtype=torch.float32, device=gn.device)
    scale = torch.clamp(limit / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


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
    """One Adam step; returns (new params, new state). ``state["t"]`` is a
    Python int step count."""
    t = state["t"] + 1
    tf = torch.tensor(float(t), dtype=torch.float32)
    # 1 - b^t in float32, as the reference computes it
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m_ = b1 * state["m"][k] + (1 - b1) * g32
        v_ = b2 * state["v"][k] + (1 - b2) * g32 * g32
        mhat = m_ / bc1.to(m_.device)
        vhat = v_ / bc2.to(v_.device)
        step = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        new_p[k] = (p.float() - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m_, v_
    return new_p, {"m": new_m, "v": new_v, "t": t}
