"""The two update rules the training mixes run, leaf by leaf: float32
arithmetic, each stored tensor rounded once to the dtype the
configuration stores it in (a model in bfloat16 keeps its weights, and
csI-ADMM its x, y and z, in bfloat16).

csI-ADMM (arXiv 2010.00914, eqs. 5a, 5b, 4c) at step k, tau = c_tau
sqrt(k), gamma = c_gamma / sqrt(k), for a committing agent a with the
decoded gradient g:

  x_a+ = (tau x_a + rho z + y_a - g) / (rho + tau)
  y_a+ = y_a + rho gamma (z - x_a+)
  z+   = z + (1/A) sum_a [(x_a+ - x_a) - (y_a+ - y_a) / rho]   (committing a)

Adam (Kingma & Ba) after clipping the gradient at a global norm:
float32 moments, bias corrections 1 - b^t.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["admm_schedule", "admm_agent_update", "admm_z_update", "clip_", "adam_"]

Tensors = Dict[str, torch.Tensor]
f32 = torch.float32


def admm_schedule(k: int, c_tau: float, c_gamma: float):
    return c_tau * math.sqrt(k), c_gamma / math.sqrt(k)


@torch.no_grad()
def admm_agent_update(x: Tensors, y: Tensors, z: Tensors, g: Tensors, zacc: Tensors,
                      tau: float, gamma: float, rho: float) -> None:
    """Eqs. 5a and 5b in place for one committing agent; adds its
    contribution to z's float32 accumulator ``zacc``."""
    for n in x:
        x32, y32, z32 = x[n].to(f32), y[n].to(f32), z[n].to(f32)
        xp = ((tau * x32 + rho * z32 + y32 - g[n]) / (rho + tau)).to(x[n].dtype)
        yp = (y32 + rho * gamma * (z32 - xp.to(f32))).to(y[n].dtype)
        zacc[n] += (xp.to(f32) - x32) - (yp.to(f32) - y32) / rho
        x[n].copy_(xp)
        y[n].copy_(yp)


@torch.no_grad()
def admm_z_update(z: Tensors, zacc: Tensors, n_agents: int) -> None:
    """Eq. 4c in place."""
    for n in z:
        z[n].copy_((z[n].to(f32) + zacc[n] / n_agents).to(z[n].dtype))


@torch.no_grad()
def clip_(grads: Tensors, max_norm: float) -> None:
    """Scale every gradient by min(1, max_norm / global norm)."""
    gn = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale)


@torch.no_grad()
def adam_(params: Tensors, grads: Tensors, m: Tensors, v: Tensors, t: int, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step in place; ``t`` is the new step count."""
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for n, p in params.items():
        m[n].mul_(b1).add_((1 - b1) * grads[n])
        v[n].mul_(b2).add_((1 - b2) * grads[n] * grads[n])
        step = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
        p.copy_((p.to(f32) - lr * step).to(p.dtype))
