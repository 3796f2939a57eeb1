"""The traced window: a few whole steps under ``torch.profiler`` on the
card, and what the per-layer metrics read from it.

Spans are the benchmark's own: ``portbench.window`` around the profiled
steps, ``portbench.batch`` / ``to_device`` / ``train_step`` /
``read_loss`` inside a step (the runtimes place them), and
``portbench.op.<name>`` around each call of an entry point of the program
that a metric asks to see (``INSTRUMENT`` in its reader), recorded with
the call's shapes. A backward node of autograd appears as the profiler's
own range ``autograd::engine::evaluate_function: <node>``. A range's
device time is that of the kernels launched inside it, nested ranges
included.

Each device operation keeps the card it ran on; busy time is read card
by card and averaged over the cell's cards.

Only ``key_averages``-sized results are kept: no chrome trace is written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["WINDOW", "OP_PREFIX", "Trace", "instrumented", "profile_steps", "union",
           "gaps", "range_key"]

WINDOW = "portbench.window"
OP_PREFIX = "portbench.op."
_BACKWARD = "autograd::engine::evaluate_function: "
_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    n_steps: int
    wall_s: float  # host clock over the profiled steps, ending in a synchronize
    window: Tuple[float, float]  # the window span in the profiler's clock (us)
    device: List[Tuple[str, float, float]]  # every device operation (us)
    host: List[Tuple[str, float, float]]  # the window thread's host ranges (us)
    ranges: Dict[str, float]  # device us under each watched range
    counts: Dict[str, int]  # how often each watched range ran
    calls: Dict[str, list]  # each instrumented entry point's calls
    card: List[int] = dataclasses.field(default_factory=list)  # each device op's card
    n_cards: int = 1  # the cards the cell runs on, 0 to n_cards - 1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def on_card(self, c: int) -> List[Tuple[str, float, float]]:
        """The device operations that ran on card ``c`` (every one when
        the trace holds no cards: one card)."""
        if not self.card:
            return list(self.device) if c == 0 else []
        return [op for op, k in zip(self.device, self.card) if k == c]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on a card,
        the mean over the cards."""
        lo, hi = self.window
        return sum(sum(e - s for s, e in union(self.on_card(c), lo, hi)) * 1e-6
                   for c in range(self.n_cards)) / self.n_cards

    def kernel_launches(self) -> int:
        return sum(1 for n, _, _ in self.device if not n.startswith(_NOT_KERNELS))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (over every card) and
        the longest idle gaps of a card by the host range running at the
        gap's midpoint (named with the card when there are several), in
        seconds."""
        lo, hi = self.window
        by_name = defaultdict(float)
        for n, s, e in self.device:
            by_name[n[:120]] += max(0.0, min(e, hi) - max(s, lo))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = [(s, e, c) for c in range(self.n_cards)
                for s, e in gaps(union(self.on_card(c), lo, hi), lo, hi)]
        idle.sort(key=lambda g: g[0] - g[1])
        named = [[self.host_at((s + e) / 2) if self.n_cards == 1
                  else f"card {c}: {self.host_at((s + e) / 2)}", (e - s) * 1e-6]
                 for s, e, c in idle[:top]]
        return {"device_ops": [[n, us * 1e-6] for n, us in ops], "idle_gaps": named}

    def host_at(self, t: float) -> str:
        """'outermost portbench span > innermost host range' at time t."""
        inside = [(e - s, n) for n, s, e in self.host if s <= t <= e]
        if not inside:
            return "(no host range)"
        inner = min(inside)[1]
        spans = [(d, n) for d, n in inside if n.startswith("portbench.")]
        outer = max(spans)[1] if spans else ""
        return inner[:120] if outer in ("", inner) else f"{outer} > {inner[:100]}"


def union(intervals: Sequence[Tuple[str, float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The merged (start, end) spans of ``intervals`` inside [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    merged: List[Tuple[float, float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def gaps(merged: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The spans of [lo, hi] that ``merged`` leaves uncovered."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def range_key(name: str) -> Optional[str]:
    """The watched range a profiler event names: an instrumented entry
    point or an autograd backward node."""
    if name.startswith(OP_PREFIX):
        return name
    if name.startswith(_BACKWARD):
        return name[len(_BACKWARD):]
    return None


def _describe(args, kwargs) -> dict:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return {
        "shapes": [tuple(t.shape) for t in tensors],
        "dtypes": [t.dtype for t in tensors],
        "kwargs": {k: v for k, v in kwargs.items() if not isinstance(v, torch.Tensor)},
        "grad": torch.is_grad_enabled() and any(t.requires_grad for t in tensors),
    }


@contextlib.contextmanager
def instrumented(ops: Sequence[Tuple[str, str]]):
    """Wrap each (module, attribute) entry point of the program in a
    ``portbench.op.<attribute>`` range that records its calls; yields
    {attribute: [call, ...]} and restores the entry points on exit."""
    calls: Dict[str, list] = {}
    saved = []
    try:
        for modname, attr in ops:
            if attr in calls:
                continue
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)
            calls[attr] = []

            def wrapped(*args, _orig=orig, _log=calls[attr], _name=OP_PREFIX + attr,
                        **kwargs):
                _log.append(_describe(args, kwargs))
                with torch.profiler.record_function(_name):
                    return _orig(*args, **kwargs)

            setattr(mod, attr, wrapped)
            saved.append((mod, attr, orig))
        yield calls
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def _device_us(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    return ev.cuda_time_total if us is None else us


def profile_steps(step: Callable[[], float], n_steps: int,
                  ops: Sequence[Tuple[str, str]] = (), cards: int = 1) -> Trace:
    """Run ``step`` ``n_steps`` times under the profiler and reduce; each
    of the ``cards`` CUDA cards is synchronized before a clock is read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        for c in range(cards):
            torch.cuda.synchronize(c)

    with instrumented(ops) as calls:
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    step()
                sync()
                wall = time.perf_counter() - t0
    events = prof.events()
    win = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    device, card, host = [], [], []
    ranges, counts = defaultdict(float), defaultdict(int)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):  # a range mirrored on the device
                device.append((e.name, s, t))
                card.append(e.device_index)
            continue
        if e.thread == win.thread and e is not win:
            host.append((e.name, s, t))
        key = range_key(e.name)
        if key is None:
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            nested = nested or range_key(parent.name) == key
            parent = parent.cpu_parent
        if not nested:
            ranges[key] += _device_us(e)
            counts[key] += 1
    return Trace(n_steps, wall, (win.time_range.start, win.time_range.end), device, host,
                 dict(ranges), dict(counts), calls, card, cards)


def op_roofline(trace: Optional[Trace], op: str, node: str, work) -> Optional[float]:
    """Percent of the bound of every call of entry point ``op`` and of its
    backward node ``node`` (by ``work.forward`` / ``work.backward``) in the
    device time under their ranges; None when the trace saw no call."""
    if trace is None or not trace.calls.get(op):
        return None
    device_us = trace.ranges.get(OP_PREFIX + op, 0.0) + trace.ranges.get(node, 0.0)
    if device_us <= 0:
        return None
    from portbench.work.roofline import bound_s

    bound = sum(bound_s(*work.forward(c)) for c in trace.calls[op])
    grad_calls = [c for c in trace.calls[op] if c["grad"]]
    n_back = trace.counts.get(node, 0)
    if n_back:
        shapes = {(tuple(c["shapes"]), tuple(c["dtypes"])) for c in grad_calls}
        if len(shapes) != 1:
            return None  # backward calls of several shapes: not attributable here
        bound += n_back * bound_s(*work.backward(grad_calls[0]))
    return 100.0 * bound / (device_us * 1e-6)
