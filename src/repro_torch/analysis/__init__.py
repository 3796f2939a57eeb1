"""Trace-contract analysis of the port.

PyTorch port of `repro.analysis`. Two gates over the invariants the
port's performance and parity rest on:

- `repro_torch.analysis.astcheck` — an AST linter of the contracts
  visible in source: the host/device split of `MethodKernel`, no host
  synchronisation or RNG in a step, spec-dataclass immutability and
  statics-key completeness.
- `repro_torch.analysis.traceaudit` — an audit of what a step actually
  runs over the reference's ten grids: K1 entered (and, on the card,
  launched) once a step on the coded paths and never on the others, no
  host synchronisation in the loop (card only), no f64 -> f32 demotion,
  the group count per grid, against the committed ``trace_audit.json``.

Both run through ``tools/torch_trace_lint.py``; ``chip_smoke.py`` runs
them on the card. Importing this package imports only the linter (no
torch), as the reference's does.
"""

from .astcheck import Finding, RULES, lint_paths

__all__ = ["Finding", "RULES", "lint_paths"]
