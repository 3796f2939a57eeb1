"""Optimizers and schedules (port of `repro.optim`): the tau^k / gamma^k
schedules of Theorem 2, and plain SGD / Adam with global-norm clipping
over a dict of parameters, used by the LM training runtime."""

from .schedules import admm_schedule, constant, rsqrt_decay, rsqrt_growth
from .sgd import (
    adam_init,
    adam_update,
    adam_update_,
    clip_by_global_norm,
    clip_by_global_norm_,
    sgd_update,
)

__all__ = [
    "admm_schedule",
    "constant",
    "rsqrt_decay",
    "rsqrt_growth",
    "adam_init",
    "adam_update",
    "adam_update_",
    "sgd_update",
    "clip_by_global_norm",
    "clip_by_global_norm_",
]
