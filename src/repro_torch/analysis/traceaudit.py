"""Step audit: what the port's step loop actually runs, grid by grid.

Counterpart of `repro.analysis.traceaudit`. The reference lowers each
kernel to a jaxpr and walks it; PyTorch has no jit and no jaxpr, so this
module observes an actual run instead. For one representative run of
each static group of a grid it builds ``prepare`` → `prepared_to_device`
→ ``setup``/``init`` as the driver does, then runs ``statics["iters"]``
steps under ``inference_mode`` and counts:

- ``k1_calls``: entries into `repro_torch.kernels.ops.coded_admm_update`,
  matched by its code object under ``sys.setprofile`` (no counter or
  wrapper is added to the program: `fig5` is launch-bound). Entries, not
  launches, are the CPU's evidence, because on the CPU `ops` sends
  tensors to the plain twin. Coded grids must enter it once a step,
  the others never (``expect_kernel``).
- ``k1_launches`` (card only, else None): the change of
  `repro_torch.kernels._build.LAUNCHES["coded_admm_update"]` over the loop; it must
  equal ``k1_calls``.
- ``host_syncs`` (card only, else None): the loop runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so any synchronisation
  with the host raises. The raise ends the group's loop and is recorded
  (1, with its message in ``sync_error``); the gate fails on it. Copies
  to the card, ``setup`` and ``init`` come before the window, ``final``
  after it.
- ``demotions``: operations whose output is float32 while some floating
  input is float64, counted by a `TorchDispatchMode` over the loop. The
  port pins 0 where `repro` pins 1 per coded signature: the reference's
  Pallas update builds f32 row masks, while the port's
  ``ops._in_acc_dtype`` passes masks in the accumulation dtype.
- ``f64_outputs`` / ``out_dtypes``: the float dtypes of ``final``'s
  (x, z) and of the last step's metrics.
- ``groups``: static signatures of the grid (`sweep._signature`), which
  are the batches a sweep dispatches.

The pin is ``trace_audit.json`` beside this module: the CPU report, in
which ``k1_launches`` and ``host_syncs`` are None. The card's report is
gated against it (refresh with ``python tools/torch_trace_lint.py
--device cpu --update-audit`` after an intentional change).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.experiments import Case
from repro_torch.experiments.sweep import _materialize, _signature
from repro_torch.kernels import ops
from repro_torch.kernels._build import LAUNCHES
from repro_torch.methods import get_kernel
from repro_torch.methods.base import prepared_to_device, resolve_device
from repro_torch.methods.driver import _stack

__all__ = [
    "AuditGrid",
    "AUDIT_GRIDS",
    "audit_report",
    "compare_report",
    "load_baseline",
    "write_baseline",
    "DEFAULT_BASELINE",
]

DEFAULT_BASELINE = pathlib.Path(__file__).with_name("trace_audit.json")

_ITERS = 12  # the reference's; enough steps to show a per-step count


@dataclasses.dataclass(frozen=True)
class AuditGrid:
    """One named audit cell: cases that must share step structure.

    ``expect_kernel`` — True: every group enters K1 once a step; False:
    never; None: recorded but not asserted. ``expect_groups`` — the
    static-signature group count the grid MUST split into.
    """

    name: str
    cases: Tuple[Case, ...]
    expect_kernel: Optional[bool]
    expect_groups: int


def _cases(method: str, dataset: str = "usps", **axes) -> Tuple[Case, ...]:
    """Cartesian Case grid over keyword axes (each value a sequence)."""
    base = dict(method=method, dataset=dataset, N=5, K=3, M=36,
                iters=_ITERS)
    names = list(axes)
    return tuple(
        Case(**{**base, **dict(zip(names, combo))})
        for combo in itertools.product(*(axes[n] for n in names))
    )


def _default_grids() -> Tuple[AuditGrid, ...]:
    # The reference's ten grids, case for case. Every coded cell of the
    # first shares ONE group: masks and coefficients are data, and the
    # gather bound MU is reconciled by max_statics.
    coded = (
        _cases("csI-ADMM", scheme=("cyclic", "mds"), S=(1, 2))
        + _cases("csI-ADMM", scheme=("approx",), S=(1,),
                 deadline=(3e-4,))
        + _cases("sI-ADMM", S=(0,))
    )
    return (
        AuditGrid("admm_coded", coded, expect_kernel=True,
                  expect_groups=1),
        AuditGrid("admm_exact", _cases("I-ADMM"), expect_kernel=False,
                  expect_groups=1),
        # Event-driven mode: its own group by the ("async", cap) suffix.
        AuditGrid("admm_async",
                  _cases("csI-ADMM", scheme=("cyclic",), S=(1,),
                         tau_max=(2e-3,)),
                  expect_kernel=True, expect_groups=1),
        # Online controller: one group per bandit algorithm; the
        # arm-stacked step still runs K1.
        AuditGrid("admm_adaptive",
                  _cases("a-csI-ADMM",
                         arms=((("cyclic", 1, None), ("approx", 1, 3e-4)),),
                         bandit=("ucb1", "exp3")),
                  expect_kernel=True, expect_groups=2),
        AuditGrid("pi_admm", _cases("pI-ADMM", S=(0, 1),
                                    scheme=("cyclic",)),
                  expect_kernel=True, expect_groups=1),
        # The compressor branches the token path in step: two groups.
        AuditGrid("cq_admm",
                  _cases("cq-sI-ADMM", compressor=("topk", "quant")),
                  expect_kernel=True, expect_groups=2),
        AuditGrid("walkman", _cases("W-ADMM"), expect_kernel=None,
                  expect_groups=1),
        AuditGrid("gossip_dadmm",
                  _cases("D-ADMM", tau_max=(0.0, 2e-3)),
                  expect_kernel=False, expect_groups=2),
        AuditGrid("gossip_dgd", _cases("DGD", tau_max=(0.0, 2e-3)),
                  expect_kernel=False, expect_groups=2),
        AuditGrid("gossip_extra", _cases("EXTRA", tau_max=(0.0, 2e-3)),
                  expect_kernel=False, expect_groups=2),
    )


AUDIT_GRIDS: Dict[str, AuditGrid] = {g.name: g for g in _default_grids()}


# --------------------------------------------------------------------------
# Observing one group's step loop
# --------------------------------------------------------------------------


def _dtypes(obj, into: set) -> set:
    """The dtypes of the tensors in ``obj`` and its lists, tuples and
    dicts (an op's arguments or outputs)."""
    if isinstance(obj, torch.Tensor):
        into.add(obj.dtype)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _dtypes(o, into)
    elif isinstance(obj, dict):
        for o in obj.values():
            _dtypes(o, into)
    return into


class _Demotions(TorchDispatchMode):
    """Counts operations with a float64 input and a float32 output."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (
            torch.float64 in _dtypes((args, kwargs), set())
            and torch.float32 in _dtypes(out, set())
        ):
            self.count += 1
        return out


class _K1Entries:
    """A ``sys.setprofile`` hook counting entries into
    `ops.coded_admm_update`; the previous hook is restored on exit, even
    when a step raises."""

    _CODE = ops.coded_admm_update.__code__

    def __init__(self):
        self.count = 0

    def _hook(self, frame, event, arg):
        if event == "call" and frame.f_code is self._CODE:
            self.count += 1

    def __enter__(self):
        self._previous = sys.getprofile()
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(self._previous)
        return False


def _float_dtypes(tensors) -> List[str]:
    return sorted({
        str(t.dtype).removeprefix("torch.")
        for t in tensors if t.is_floating_point()
    })


def _audit_group(kernel, case, prob, net, device, dtype) -> Dict[str, object]:
    """Run ONE representative run of a static group and count."""
    cfg = kernel.config(case)
    prep = kernel.prepare(prob, net, cfg, case.iters)
    statics = {**prep.statics, **prep.max_statics}
    consts, steps = prepared_to_device(
        *_stack([prep]), device=device, dtype=dtype
    )
    on_card = device.type == "cuda"
    counts: Dict[str, object] = {"iters": statics["iters"]}
    sync_error = None
    with torch.inference_mode():
        aux = kernel.setup(consts, statics)
        # Iteration-major, as the driver lays them out.
        steps = tuple(s.transpose(0, 1).contiguous() for s in steps)
        state = kernel.init(aux, statics)
        launches0 = LAUNCHES["coded_admm_update"]
        metrics = ()
        with _K1Entries() as entries, _Demotions() as demoted:
            if on_card:
                debug_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            try:
                for k in range(statics["iters"]):
                    state, metrics = kernel.step(
                        state, tuple(s[k] for s in steps), aux, statics
                    )
            except RuntimeError as exc:
                if not (on_card and "synchroniz" in str(exc)):
                    raise
                sync_error = str(exc).splitlines()[0]
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(debug_mode)
        x, z = kernel.final(state, aux, statics)
    counts["k1_calls"] = entries.count
    counts["k1_launches"] = (
        LAUNCHES["coded_admm_update"] - launches0
        if on_card else None
    )
    counts["host_syncs"] = (int(sync_error is not None) if on_card else None)
    if sync_error is not None:
        counts["sync_error"] = sync_error
    counts["demotions"] = demoted.count
    out_dtypes = _float_dtypes((x, z) + tuple(metrics))
    counts["f64_outputs"] = out_dtypes == ["float64"]
    counts["out_dtypes"] = out_dtypes
    return counts


def audit_report(
    names: Optional[Sequence[str]] = None,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> Dict[str, dict]:
    """Run every audit grid (or those in ``names``) on ``device`` and
    return the report. ``device="cuda"`` raises without a card."""
    device = resolve_device(device)
    report: Dict[str, dict] = {}
    net_cache: dict = {}
    prob_cache: dict = {}
    for grid in AUDIT_GRIDS.values():
        if names and grid.name not in names:
            continue
        groups: Dict[tuple, Tuple] = {}
        for case in grid.cases:
            net, prob = _materialize(case, net_cache, prob_cache)
            groups.setdefault(_signature(case, prob), (case, prob, net))
        entry: Dict[str, object] = {
            "groups": len(groups),
            "expect_kernel": grid.expect_kernel,
            "signatures": {},
        }
        for sig, (case, prob, net) in sorted(
            groups.items(), key=lambda kv: repr(kv[0])
        ):
            entry["signatures"][repr(sig)] = _audit_group(
                get_kernel(case.method), case, prob, net, device, dtype
            )
        report[grid.name] = entry
    return report


# --------------------------------------------------------------------------
# Gate
# --------------------------------------------------------------------------


def compare_report(
    fresh: Dict[str, dict],
    baseline: Optional[Dict[str, dict]],
) -> Tuple[List[str], List[str]]:
    """(failures, notes) of the fresh report vs declared + pinned
    contracts. ``baseline=None`` checks only the unconditional ones."""
    failures: List[str] = []
    notes: List[str] = []

    for name, entry in fresh.items():
        grid = AUDIT_GRIDS[name]
        if entry["groups"] != grid.expect_groups:
            failures.append(
                f"{name}: {entry['groups']} static groups, grid declares "
                f"{grid.expect_groups} — a statics change split (or "
                "merged) the batches"
            )
        for sig, counts in entry["signatures"].items():
            where = f"{name} {sig}"
            if counts["host_syncs"]:
                failures.append(
                    f"{where}: host sync in the step loop "
                    f"({counts.get('sync_error', 'no message')})"
                )
            calls, iters = counts["k1_calls"], counts["iters"]
            if grid.expect_kernel is True and calls != iters:
                failures.append(
                    f"{where}: K1 entered {calls} times in {iters} steps "
                    "— the coded path lost the fused decode-combine "
                    "kernel"
                )
            if grid.expect_kernel is False and calls:
                failures.append(
                    f"{where}: K1 entered {calls} times on a non-coded "
                    "path"
                )
            launches = counts["k1_launches"]
            if launches is not None and launches != calls:
                failures.append(
                    f"{where}: {launches} K1 launches for {calls} entries"
                )
            if not counts["f64_outputs"]:
                failures.append(
                    f"{where}: float outputs demoted — "
                    f"{counts['out_dtypes']} (f64 contract)"
                )

    if baseline is None:
        notes.append("no baseline: unconditional checks only")
        return failures, notes

    for name, base_entry in baseline.items():
        if name not in fresh:
            failures.append(
                f"{name}: pinned in baseline but absent from the fresh "
                "audit — grid removed without --update-audit"
            )
            continue
        entry = fresh[name]
        if entry["groups"] > base_entry["groups"]:
            failures.append(
                f"{name}: static groups grew {base_entry['groups']} -> "
                f"{entry['groups']} (dispatch regression)"
            )
        elif entry["groups"] < base_entry["groups"]:
            notes.append(
                f"{name}: static groups shrank {base_entry['groups']} -> "
                f"{entry['groups']} — improvement; refresh with "
                "--update-audit"
            )
        base_sigs = base_entry["signatures"]
        for sig, counts in entry["signatures"].items():
            base = base_sigs.get(sig)
            if base is None:
                notes.append(f"{name}: NEW signature {sig}")
                continue
            if counts["demotions"] > base["demotions"]:
                failures.append(
                    f"{name} {sig}: f64->f32 demotions grew "
                    f"{base['demotions']} -> {counts['demotions']} — "
                    "new silent precision loss"
                )
            elif counts["demotions"] < base["demotions"]:
                notes.append(
                    f"{name} {sig}: demotions shrank "
                    f"{base['demotions']} -> {counts['demotions']}; "
                    "refresh with --update-audit"
                )
    for name in fresh:
        if name not in baseline:
            notes.append(f"{name}: NEW grid (not yet pinned)")
    return failures, notes


def load_baseline(
    path: pathlib.Path = DEFAULT_BASELINE,
) -> Optional[Dict[str, dict]]:
    if not path.exists():
        return None
    return json.loads(path.read_text(encoding="utf-8"))


def write_baseline(
    report: Dict[str, dict], path: pathlib.Path = DEFAULT_BASELINE
) -> None:
    path.write_text(
        json.dumps(report, indent=2, sort_keys=True) + "\n",
        encoding="utf-8",
    )
