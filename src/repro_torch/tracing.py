"""Named spans of the training steps, on the profiler's clock.

``span(name)`` marks one phase of a step (``plain.forward``,
``consensus.update``, ...). While a ``torch.profiler`` records, it is a
``torch.profiler.record_function`` range: a profiler event on the same
clock as the device's operations and the CUDA runtime's calls, so each
device operation can be put down to the phase that launched it and each
idle gap to the phase the host was in. Otherwise it is one shared null
context, which makes no dispatcher call (``record_function`` costs
microseconds even with no profiler). Tracing has no switch of its own: a
recording profiler turns it on.

Spans sit at phase level only, never per leaf or per kernel; each adds no
tensor, allocation, sync or launch.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the phase ``name`` for a recording
    profiler; a shared no-op when none records."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
