"""Batched experiment engine: multi-seed / multi-config sweeps on a runs
axis.

PyTorch port of `repro.experiments`:

- :mod:`repro_torch.experiments.sweep` — `Case` (one fully-specified run),
  `SweepSpec` (base case + axes -> Cartesian grid), and `run_sweep`, which
  groups cases by static signature and runs each group as one batch on a
  leading runs axis.
- :mod:`repro_torch.experiments.registry` — the named paper-figure sweeps
  of the ported slice.
- :mod:`repro_torch.experiments.results` — mean/CI reduction over sweep
  axes and CSV row emission.
"""

from repro_torch.methods import Reduction, reduce_trace

from .registry import SWEEPS, get_sweep
from .results import emit_rows, mean_ci, reduce_mean, resample_runs, stack_field
from .sweep import Case, SweepResult, SweepSpec, run_sweep

__all__ = [
    "Case",
    "SweepSpec",
    "SweepResult",
    "run_sweep",
    "Reduction",
    "reduce_trace",
    "SWEEPS",
    "get_sweep",
    "mean_ci",
    "reduce_mean",
    "resample_runs",
    "stack_field",
    "emit_rows",
]
