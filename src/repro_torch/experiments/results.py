"""Reduction + emission for sweep results (DESIGN.md §7, §10).

Numpy-only port of `repro.experiments.results`.

Mean/CI over the seed axis (the paper averages Figs. 3-5 over independent
runs) and CSV emission compatible with `benchmarks.common.Rows`.

Two reduction axes:

- iteration axis (default): traces align by iteration index, so stacking
  runs is a plain array stack;
- cumulative-cost axis (``x="sim_time"`` or ``x="comm_cost"``): each
  run's clock advances by different amounts per iteration (straggler
  draws, topologies, compressed hops), so runs are first step-resampled
  onto a shared grid (`resample_runs`) — the paper's accuracy-vs-running-
  time comparison (Figs. 3(e), 4) — and the last grid point is the
  accuracy-at-time-budget readout (the budget is the slowest common
  horizon, i.e. the smallest final cumulative cost across the group).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .sweep import SweepResult

__all__ = [
    "stack_field",
    "mean_ci",
    "resample_runs",
    "reduce_mean",
    "emit_rows",
]


def stack_field(traces: Sequence, field: str) -> np.ndarray:
    """Stack one `Trace` field over runs -> (R, iters)."""
    return np.stack([np.asarray(getattr(t, field)) for t in traces])


def _as_float(values: np.ndarray) -> np.ndarray:
    """Promote integer-typed metric arrays (e.g. a unit-count comm_cost)
    to float64 so downstream mean/CI math never runs in integer
    arithmetic; float inputs pass through untouched."""
    values = np.asarray(values)
    if not np.issubdtype(values.dtype, np.floating):
        return values.astype(np.float64)
    return values


def mean_ci(
    values: np.ndarray, axis: int = 0, z: float = 1.96
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and normal-approximation CI half-width along ``axis``."""
    values = _as_float(values)
    n = values.shape[axis]
    mean = values.mean(axis=axis)
    if n < 2:
        return mean, np.zeros_like(mean)
    sem = values.std(axis=axis, ddof=1) / np.sqrt(n)
    return mean, z * sem


def resample_runs(
    xs: np.ndarray, ys: np.ndarray, n_points: int = 200
) -> Tuple[np.ndarray, np.ndarray]:
    """Step-resample R runs' (cumulative x, metric y) onto a shared grid.

    Args:
      xs: (R, iters) strictly increasing cumulative cost per run
        (sim_time / comm_cost).
      ys: (R, iters) metric recorded at each iteration's completion.
      n_points: grid resolution.

    Returns (grid, values): ``grid`` is (n_points,) from 0 to the
    smallest final cost across runs (so no run is extrapolated), and
    ``values`` is (R, n_points) where values[r, t] is the metric at the
    last iteration run r completed by grid[t] — a right-continuous step
    function. Before a run's first completion the first recorded metric
    is held (the scan records no iteration-0 point). Integer-typed
    metrics are promoted to float (CI math downstream).

    One batched pass instead of a per-run ``np.searchsorted`` loop: for
    each value x[r, j] we find its insertion point into the SHARED grid
    (the dual of searching each grid point into per-run xs — identical
    comparisons, so the result is bit-identical to the loop), histogram
    the insertion points per run with one offset `bincount`, and cumsum
    into "iterations completed by grid[t]" counts.
    """
    xs, ys = np.asarray(xs), _as_float(ys)
    if xs.ndim != 2 or xs.shape != ys.shape:
        raise ValueError(f"xs/ys must be (R, iters), got {xs.shape}")
    R, iters = xs.shape
    grid = np.linspace(0.0, xs[:, -1].min(), n_points)
    # p[r, j] = #{t : grid[t] < xs[r, j]}; values past the grid end land
    # in the extra slot n_points and never enter the cumsum below.
    p = np.searchsorted(grid, xs.ravel(), side="left")
    p += np.repeat(np.arange(R) * (n_points + 1), iters)
    hist = np.bincount(p, minlength=R * (n_points + 1)).reshape(
        R, n_points + 1
    )
    # counts[r, t] = #{j : xs[r, j] <= grid[t]} == the loop's
    # searchsorted(xs[r], grid, "right"); -1 and clip = last completed
    # iteration, held at the first record before any completion.
    counts = np.cumsum(hist[:, :n_points], axis=1)
    idx = np.clip(counts - 1, 0, iters - 1)
    return grid, np.take_along_axis(ys, idx, axis=1)


def reduce_mean(
    result: SweepResult,
    by: Sequence[str],
    field: str = "accuracy",
    z: float = 1.96,
    x: Optional[str] = None,
    n_points: int = 200,
) -> Dict[tuple, dict]:
    """Group cases by the ``by`` fields; mean/CI the rest (the seed axis).

    With ``x`` set to a cumulative Trace field ("sim_time"/"comm_cost"),
    each group's runs are first step-resampled onto a shared grid of
    that axis (`resample_runs`), so the mean is an honest
    accuracy-vs-running-time curve rather than an iteration-index
    average of misaligned clocks.

    Returns {key_tuple: {"mean": (P,), "ci": (P,), "n": int,
    "cases": [Case, ...][, "x": (P,) grid]}} with keys ordered by first
    appearance (P = iters, or n_points when resampled).

    Streamed results (``result.reduced`` set) reduce the pre-summarized
    grid arrays instead: ``field`` may be a full reduction key
    ("accuracy/at_budget") or a plain metric name (mapped to
    "{field}/final"), and ``x`` is ignored — budget/target axes are
    declared in the `Reduction` spec, so there is nothing to resample.
    """
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(result.cases):
        key = tuple(getattr(c, f) for f in by)
        groups.setdefault(key, []).append(i)
    reduced = getattr(result, "reduced", None)
    if reduced is not None:
        vals = _reduced_field(reduced, field)
        out = {}
        for key, idxs in groups.items():
            entry = {
                "n": len(idxs),
                "cases": [result.cases[i] for i in idxs],
            }
            entry["mean"], entry["ci"] = mean_ci(vals[idxs], axis=0, z=z)
            out[key] = entry
        return out
    out: Dict[tuple, dict] = {}
    for key, idxs in groups.items():
        traces = [result.traces[i] for i in idxs]
        stacked = stack_field(traces, field)
        entry = {"n": len(idxs), "cases": [result.cases[i] for i in idxs]}
        if x is not None:
            grid, stacked = resample_runs(
                stack_field(traces, x), stacked, n_points
            )
            entry["x"] = grid
        entry["mean"], entry["ci"] = mean_ci(stacked, axis=0, z=z)
        out[key] = entry
    return out


def _reduced_field(reduced: Dict[str, np.ndarray], field: str) -> np.ndarray:
    """Resolve a field name against a streamed summary dict: exact key
    first, then the metric's "/final" readout."""
    if field in reduced:
        return reduced[field]
    final = f"{field}/final"
    if final in reduced:
        return reduced[final]
    raise KeyError(
        f"field {field!r} not in the streamed reduction; available: "
        f"{sorted(reduced)}"
    )


def emit_rows(
    result: SweepResult,
    rows,
    prefix: str,
    by: Sequence[str],
    field: str = "accuracy",
    extra: Optional[dict] = None,
    x: Optional[str] = None,
    n_points: int = 200,
) -> Dict[tuple, dict]:
    """Reduce and append one `benchmarks.common.Rows` row per group.

    Row name is ``{prefix}/{method}[{by=value,...}]``; the derived column
    records the final mean +- CI and the run count — on the iteration
    axis by default, or at the shared cumulative budget when ``x`` is a
    cumulative Trace field (accuracy-at-time-budget for x="sim_time").
    Returns the reduction so callers can also plot / post-process.
    """
    red = reduce_mean(result, by, field=field, x=x, n_points=n_points)
    for key, r in red.items():
        case = r["cases"][0]
        kv = ",".join(f"{f}={v}" for f, v in zip(by, key) if f != "method")
        name = f"{prefix}/{case.method}" + (f"[{kv}]" if kv else "")
        # Streamed summaries may be scalar per run (a "/final" readout) or
        # a budget/target vector; the derived column reads the last entry
        # either way, matching the materialized path's final-grid-point
        # convention.
        mean, ci = np.atleast_1d(r["mean"]), np.atleast_1d(r["ci"])
        derived = (
            f"final_{field}={mean[-1]:.5f};ci={ci[-1]:.5f};"
            f"runs={r['n']}"
        )
        if x is not None and "x" in r:
            derived += f";{x}_budget={r['x'][-1]:.5g}"
        if extra:
            derived += "".join(f";{k}={v}" for k, v in extra.items())
        rows.add(name, 0.0, derived)
    return red
