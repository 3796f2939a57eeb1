"""A training step split by the program's own phase spans, on the
profiler's clock.

The port marks the phases of its training steps while a profiler records
(`repro_torch.tracing`): ``plain.step`` holding ``plain.forward``,
``.backward``, ``.clip``, ``.adam``; ``consensus.step`` holding
``consensus.row_weights``, ``.load``, ``.forward``, ``.backward``,
``.update``, ``.z_update``. They are host ranges of the window thread,
beside the benchmark's own spans and the CUDA runtime calls made there.

Two rules put the device's time down to phases; each reports, beside its
result, what it could not place:

- busy (`place`): a device operation belongs to the phase whose span
  holds the host time at which it was launched. Backward kernels are
  launched from autograd's device thread while the window thread sits
  inside ``*.backward``, so this places them right; the device's own
  interval would not, as it lags the host by the queue.
- idle (`idle_in`): a phase's idle time is the part of the device's idle
  set (the gaps in the union of device operations) that falls inside the
  phase's span intervals, that is, idle put down to what the host was
  doing at the time.

`portbench.trace.Trace` holds the device operations and the window
thread's host ranges but not each operation's launch time, so the readers
use the idle rule and the count of host syncs; `place` takes launch times
from a caller that has them.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace import gaps, union

__all__ = ["STEP", "FORWARD", "BACKWARD", "MODEL", "UPDATE", "SYNCS", "intervals",
           "place", "overlap_us", "idle_in", "is_sync", "syncs_in"]

STEP = ("plain.step", "consensus.step")
FORWARD = ("plain.forward", "consensus.forward")
BACKWARD = ("plain.backward", "consensus.backward")
MODEL = FORWARD + BACKWARD
UPDATE = ("consensus.row_weights", "consensus.load", "consensus.update",
          "consensus.z_update", "plain.clip", "plain.adam")
# CUDA runtime calls that block the host until the device has caught up.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")

Interval = Tuple[float, float]
Op = Tuple[str, float, float]


def intervals(host: Sequence[Op], names: Sequence[str]) -> List[Interval]:
    """The merged (start, end) intervals of the host ranges named in
    ``names``, in order."""
    merged: List[Interval] = []
    for s, e in sorted((s, e) for n, s, e in host if n in names):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _holds(spans: List[Interval], starts: List[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def place(device: Sequence[Op], launch_at: Sequence[Optional[float]],
          groups: Dict[str, List[Interval]]) -> Tuple[Dict[str, List[Op]], List[Op]]:
    """The device operations by the group whose merged intervals hold
    their launch time (the first such group, in ``groups``' order), and
    the operations no group holds or whose launch time is None."""
    starts = {g: [s for s, _ in spans] for g, spans in groups.items()}
    placed: Dict[str, List[Op]] = {g: [] for g in groups}
    unplaced: List[Op] = []
    for op, t in zip(device, launch_at):
        group = None if t is None else next(
            (g for g, spans in groups.items() if _holds(spans, starts[g], t)), None)
        (unplaced if group is None else placed[group]).append(op)
    return placed, unplaced


def overlap_us(a: List[Interval], b: List[Interval]) -> float:
    """The length both sorted, disjoint interval lists cover."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(device: Sequence[Op], spans: List[Interval], lo: float, hi: float) -> float:
    """The device's idle time in [lo, hi] that falls inside ``spans``."""
    return overlap_us(gaps(union(device, lo, hi), lo, hi), spans)


def is_sync(name: str) -> bool:
    """A runtime call that blocks the host on the device (a per-thread
    stream's ``_ptsz`` form included; ``cudaMemcpyAsync`` is not one)."""
    return name.split("_")[0] in SYNCS


def syncs_in(calls: Sequence[Op], spans: List[Interval]) -> int:
    """The blocking runtime calls among ``calls`` that start inside
    ``spans``."""
    starts = [s for s, _ in spans]
    return sum(1 for n, s, _ in calls if is_sync(n) and _holds(spans, starts, s))
