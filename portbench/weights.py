"""Weights from ``--seed``, made by the benchmark and not by the program.

A family's reference names every leaf with its shape, its init rule and
the dtype it is stored in (``param_spec``). All normally drawn leaves come
from one ``torch.Generator`` on the run's device, drawn in the model's
dtype into one flat buffer in a few large calls, then scaled leaf by
leaf; constant leaves are filled. The same seed gives the same tensors,
so the program and the reference start from the same weights.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["make_weights", "load_into", "leaf_dtype"]

_CALL = 1 << 28  # elements a draw


def leaf_dtype(rule_dtype: str, model_dtype: torch.dtype) -> torch.dtype:
    return model_dtype if rule_dtype == "model" else getattr(torch, rule_dtype)


def make_weights(spec: Dict[str, tuple], model_dtype: torch.dtype, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> tensor in its stored dtype on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = [(n, shape, rule[1]) for n, (shape, rule, dt) in spec.items()
              if rule[0] == "normal"]
    if any(spec[n][2] != "model" for n, _, _ in normal):
        raise ValueError("normally drawn leaves are stored in the model's dtype")
    total = sum(torch.Size(shape).numel() for _, shape, _ in normal)
    flat = torch.empty(total, dtype=model_dtype, device=device)
    for start in range(0, total, _CALL):
        flat[start:start + _CALL].normal_(generator=gen)
    out, off = {}, 0
    for n, shape, scale in normal:
        size = torch.Size(shape).numel()
        out[n] = flat[off:off + size].view(shape).mul_(scale)
        off += size
    for n, (shape, rule, dt) in spec.items():
        dtype = leaf_dtype(dt, model_dtype)
        if rule[0] == "const":
            out[n] = torch.full(shape, rule[1], dtype=dtype, device=device)
        elif rule[0] == "log_linspace":
            lo, hi = rule[1], rule[2]
            ramp = torch.linspace(lo, hi, shape[0], dtype=torch.float64)
            out[n] = torch.log(ramp).to(dtype).to(device)
        elif rule[0] != "normal":
            raise ValueError(f"unknown init rule {rule!r} for {n}")
    return {n: out[n] for n in spec}


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters, which must have
    exactly these names, shapes and dtypes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"the model's parameters and the reference's leaves differ: "
            f"only the model {sorted(set(params) - set(weights))[:5]}, "
            f"only the reference {sorted(set(weights) - set(params))[:5]}")
    for n, p in params.items():
        w = weights[n]
        if p.shape != w.shape or p.dtype != w.dtype:
            raise ValueError(f"{n}: model {tuple(p.shape)} {p.dtype}, "
                             f"reference {tuple(w.shape)} {w.dtype}")
        p.copy_(w)
