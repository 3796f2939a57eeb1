"""Streaming in-loop reductions: O(grid) sweep memory.

PyTorch port of `repro.methods.reductions`. A full
`repro_torch.core.admm.Trace` keeps every per-iteration metric — memory
O(iters x runs) — which caps sweep grids at tens of runs. The paper's
claims, however, are statistical: accuracy at a time budget, time to
reach an accuracy target, quantiles over straggler realizations. A
`Reduction` declares exactly those summaries, and the driver folds them
into its step loop's carry, so a run's footprint is a fixed-size set of
tensors whatever ``iters`` is:

- **running mean/M2** (Welford) of each metric over iterations;
- **running min** and **final value** of each metric;
- **value at budget**: per-run budget-crossing detection against the
  cumulative ``sim_time``/``comm_cost`` clock carried through the loop
  (the right-continuous step semantics of
  `repro_torch.experiments.results.resample_runs`);
- **time to target**: first cumulative clock value at which the metric
  reaches each target (+inf when never);
- **streaming quantiles**: a fixed-bin histogram sketch in the carry,
  collapsed to quantile estimates at ``finalize_carry``.

The fold is written over the leading runs axis R (the reference's is one
run under ``vmap``) and keeps the reference's order of operations, so at
float64 it agrees with `repro`'s in-scan fold to round-off. Only the
fixed-size summaries leave the device. `reduce_trace` is the numpy
post-hoc reference, copied from `repro`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["Reduction", "METRIC_FIELDS", "CLOCK_AXES", "reduce_trace"]

# Per-step metric tuple emitted by every MethodKernel.step, in order.
METRIC_FIELDS = ("accuracy", "test_error", "z_err")
# Cumulative clocks carried through the loop: index into the (R, 2) carry.
CLOCK_AXES = ("sim_time", "comm_cost")


@dataclasses.dataclass(frozen=True)
class Reduction:
    """Declarative spec of the in-loop summaries (frozen and hashable).

    Attributes:
      fields: metric fields to reduce (subset of `METRIC_FIELDS`). Every
        field always gets final/mean/var/min summaries.
      budgets: cumulative-``x`` budgets; each field additionally reports
        its value at the last iteration completed within each budget
        (held at the first recorded value when no iteration completes —
        the `resample_runs` step-function convention).
      x: the budget/time axis — "sim_time" or "comm_cost".
      targets: metric thresholds; each field additionally reports the
        first cumulative ``x`` at which it reached each target (+inf
        when never).
      quantiles: quantile levels in (0, 1]; estimated from a fixed-bin
        histogram of the metric over iterations (``bins`` bins spanning
        [lo, hi], out-of-range values clipped into the edge bins).
      bins, lo, hi: the histogram sketch geometry.
      final_x: also return the per-run final iterates (N, p, d)/(p, d)
        — O(model) per run, off by default.
    """

    fields: Tuple[str, ...] = ("accuracy",)
    budgets: Tuple[float, ...] = ()
    x: str = "sim_time"
    targets: Tuple[float, ...] = ()
    quantiles: Tuple[float, ...] = ()
    bins: int = 64
    lo: float = 0.0
    hi: float = 1.5
    final_x: bool = False

    def __post_init__(self) -> None:
        unknown = set(self.fields) - set(METRIC_FIELDS)
        if not self.fields or unknown:
            raise ValueError(
                f"fields must be a non-empty subset of {METRIC_FIELDS}, "
                f"got {self.fields}"
            )
        if self.x not in CLOCK_AXES:
            raise ValueError(
                f"unknown reduction axis {self.x!r}; known: {CLOCK_AXES}"
            )
        if any(b <= 0 for b in self.budgets):
            raise ValueError(f"budgets must be positive, got {self.budgets}")
        if any(not 0.0 < q <= 1.0 for q in self.quantiles):
            raise ValueError(
                f"quantiles must lie in (0, 1], got {self.quantiles}"
            )
        if self.quantiles and (self.bins < 1 or self.hi <= self.lo):
            raise ValueError(
                f"histogram sketch needs bins >= 1 and hi > lo, got "
                f"bins={self.bins}, [{self.lo}, {self.hi})"
            )

    @property
    def axis_index(self) -> int:
        return CLOCK_AXES.index(self.x)

    def keys(self) -> Tuple[str, ...]:
        """Output keys, in emission order (clock finals, then per-field)."""
        out = [f"{ax}/final" for ax in CLOCK_AXES]
        for f in self.fields:
            out += [f"{f}/final", f"{f}/mean", f"{f}/var", f"{f}/min"]
            if self.budgets:
                out.append(f"{f}/at_budget")
            if self.targets:
                out.append(f"{f}/time_to")
            if self.quantiles:
                out.append(f"{f}/quantiles")
        if self.final_x:
            out += ["final_x", "final_z"]
        return tuple(out)

    # -- in-loop fold (torch over R, called from the driver's step loop) ---

    def init_carry(self, R: int, dtype: torch.dtype, device) -> dict:
        """Fixed-size carry of R runs: O(budgets+targets+bins) per run.

        The iteration count ``k`` is shared by every run of a loop (they
        step together), so it is a Python int, not a tensor."""
        kw = dict(dtype=dtype, device=device)
        carry = {
            "k": 0,
            "clock": torch.zeros((R, len(CLOCK_AXES)), **kw),
            # Loop constants, made on the device once.
            "budgets": torch.tensor(self.budgets, **kw),
            "targets": torch.tensor(self.targets, **kw),
            "runs": torch.arange(R, device=device),
        }
        for f in self.fields:
            st = {
                "last": torch.zeros((R,), **kw),
                "mean": torch.zeros((R,), **kw),
                "m2": torch.zeros((R,), **kw),
                "min": torch.full((R,), float("inf"), **kw),
            }
            if self.budgets:
                st["at_budget"] = torch.zeros((R, len(self.budgets)), **kw)
            if self.targets:
                st["time_to"] = torch.full(
                    (R, len(self.targets)), float("inf"), **kw
                )
            if self.quantiles:
                st["hist"] = torch.zeros((R, self.bins), **kw)
            carry[f] = st
        return carry

    def update_carry(self, carry: dict, metrics, dclock) -> dict:
        """Fold one iteration's (acc, test_err, z_err), each (R,), and the
        (R, 2) clock increments."""
        vals = dict(zip(METRIC_FIELDS, metrics))
        k = carry["k"]
        dtype = carry["clock"].dtype
        clock = carry["clock"] + dclock.to(dtype)
        x = clock[:, self.axis_index, None]  # (R, 1) against (R, B|T)
        first = k == 0
        new = dict(carry, k=k + 1, clock=clock)
        for f in self.fields:
            # Cast into the carry dtype, as the reference's scan carry.
            st, m = carry[f], vals[f].to(dtype)
            # Welford over iterations: mean + M2 in one pass.
            kf = float(k + 1)
            delta = m - st["mean"]
            mean = st["mean"] + delta / kf
            out = {
                "last": m,
                "mean": mean,
                "m2": st["m2"] + delta * (m - mean),
                "min": torch.minimum(st["min"], m),
            }
            m1 = m[:, None]
            if self.budgets:
                # value at the LAST iteration completed within each budget;
                # the first iteration seeds every budget (hold-first).
                out["at_budget"] = (
                    m1.expand_as(st["at_budget"]) if first
                    else torch.where(
                        x <= carry["budgets"], m1, st["at_budget"]
                    )
                )
            if self.targets:
                out["time_to"] = torch.where(
                    (m1 <= carry["targets"]) & torch.isinf(st["time_to"]),
                    x, st["time_to"],
                )
            if self.quantiles:
                # In place: the carry is the loop's own.
                st["hist"][carry["runs"], _bin_index(self, m)] += 1
                out["hist"] = st["hist"]
            new[f] = out
        return new

    def finalize_carry(self, carry: dict) -> Dict[str, torch.Tensor]:
        """Collapse the carry to the flat output dict, each (R, ...)."""
        out = {}
        for i, ax in enumerate(CLOCK_AXES):
            out[f"{ax}/final"] = carry["clock"][:, i]
        k = carry["k"]
        for f in self.fields:
            st = carry[f]
            out[f"{f}/final"] = st["last"]
            out[f"{f}/mean"] = st["mean"]
            out[f"{f}/var"] = st["m2"] / float(max(k - 1, 1))
            out[f"{f}/min"] = st["min"]
            if self.budgets:
                out[f"{f}/at_budget"] = st["at_budget"]
            if self.targets:
                out[f"{f}/time_to"] = st["time_to"]
            if self.quantiles:
                cdf = torch.cumsum(st["hist"], dim=1)
                q = torch.tensor(
                    self.quantiles, dtype=cdf.dtype, device=cdf.device
                ) * float(k)
                idx = torch.searchsorted(
                    cdf, q.expand(cdf.shape[0], -1).contiguous()
                ).clamp(0, self.bins - 1)
                out[f"{f}/quantiles"] = self.lo + (
                    idx.to(cdf.dtype) + 0.5
                ) * (self.hi - self.lo) / self.bins
        return out


def _bin_index(spec: Reduction, m: torch.Tensor) -> torch.Tensor:
    """Histogram bin of a metric value, edge-clipped (torch and numpy
    agree)."""
    scaled = torch.floor((m - spec.lo) / (spec.hi - spec.lo) * spec.bins)
    return scaled.clamp(0, spec.bins - 1).to(torch.int64)


def reduce_trace(spec: Reduction, trace) -> Dict[str, np.ndarray]:
    """Post-hoc reference: apply ``spec`` to a materialized `Trace`.

    The correctness contract of the streaming layer: for every kernel and
    execution tier, the in-loop fold equals this numpy reduction of the
    full per-iteration record to round-off.
    """
    clocks = {
        "sim_time": np.asarray(trace.sim_time, dtype=np.float64),
        "comm_cost": np.asarray(trace.comm_cost, dtype=np.float64),
    }
    x = clocks[spec.x]
    out: Dict[str, np.ndarray] = {
        f"{ax}/final": clocks[ax][-1] for ax in CLOCK_AXES
    }
    for f in spec.fields:
        ys = np.asarray(getattr(trace, f), dtype=np.float64)
        n = len(ys)
        out[f"{f}/final"] = ys[-1]
        out[f"{f}/mean"] = ys.mean()
        out[f"{f}/var"] = ys.var(ddof=1) if n > 1 else np.float64(0.0)
        out[f"{f}/min"] = ys.min()
        if spec.budgets:
            idx = np.searchsorted(x, np.asarray(spec.budgets), "right") - 1
            out[f"{f}/at_budget"] = ys[np.clip(idx, 0, n - 1)]
        if spec.targets:
            t2t = np.full(len(spec.targets), np.inf)
            for j, tg in enumerate(spec.targets):
                hit = np.nonzero(ys <= tg)[0]
                if len(hit):
                    t2t[j] = x[hit[0]]
            out[f"{f}/time_to"] = t2t
        if spec.quantiles:
            bins = np.clip(
                np.floor((ys - spec.lo) / (spec.hi - spec.lo) * spec.bins),
                0, spec.bins - 1,
            ).astype(int)
            hist = np.bincount(bins, minlength=spec.bins).astype(np.float64)
            cdf = np.cumsum(hist)
            q = np.asarray(spec.quantiles, dtype=np.float64)
            idx = np.clip(np.searchsorted(cdf, q * n), 0, spec.bins - 1)
            out[f"{f}/quantiles"] = spec.lo + (idx + 0.5) * (
                spec.hi - spec.lo
            ) / spec.bins
    if spec.final_x:
        out["final_x"] = np.asarray(trace.final_x)
        out["final_z"] = np.asarray(trace.final_z)
    return {k: np.asarray(v) for k, v in out.items()}
