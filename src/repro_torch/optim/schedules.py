"""tau^k / gamma^k schedules (Theorem 2) + generic step-size schedules
(port of `repro.optim.schedules`). Each returns a function of the 1-based
step k giving a float32 0-d tensor."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["rsqrt_growth", "rsqrt_decay", "constant", "admm_schedule"]


def _f32(k) -> torch.Tensor:
    return torch.as_tensor(k, dtype=torch.float32)


def rsqrt_growth(c: float) -> Callable:
    """tau^k = c * sqrt(k) (k is 1-based)."""

    def f(k):
        return _f32(c) * torch.sqrt(_f32(k))

    return f


def rsqrt_decay(c: float) -> Callable:
    """gamma^k = c / sqrt(k) (k is 1-based)."""

    def f(k):
        return _f32(c) / torch.sqrt(_f32(k))  # not c / t: that is c * (1/t)

    return f


def constant(c: float) -> Callable:
    def f(k):
        return torch.full((), c, dtype=torch.float32)

    return f


def admm_schedule(c_tau: float, c_gamma: float) -> Tuple[Callable, Callable]:
    """The (tau^k, gamma^k) pair sI-ADMM converges under (Theorem 2)."""
    return rsqrt_growth(c_tau), rsqrt_decay(c_gamma)
