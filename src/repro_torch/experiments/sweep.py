"""Grid/axes spec -> batched run -> per-case traces.

PyTorch port of `repro.experiments.sweep`. A `Case` pins down ONE run
completely: method, dataset, topology, ADMM hyper-parameters, straggler
model, and seed (copied whole from the reference, so labels and hashes
match). A `SweepSpec` is a base case plus named axes; its Cartesian
expansion is the grid. `run_sweep` groups the grid by *static signature*
(`MethodKernel.static_signature`: shapes, K, P, exact_x, iters, method
kernel) and runs each group as one batch on a leading runs axis
(`repro_torch.methods.run_batch`) on the requested device. Host-side
sampling (topology, data allocation, straggler times, decode vectors)
stays per-run and is stacked into the batch's per-step inputs.

Modes: "serial" (one run at a time), "batched" (one device) and
"sharded" (the runs axis split over several devices,
`repro_torch.methods.run_sharded`); "auto" resolves to "sharded" if and
only if ``device`` is CUDA and more than one CUDA device is visible, else
"batched". With a `Reduction` (``reductions=`` or the spec's own) the
groups fold fixed-size summaries in their step loops instead of keeping
Traces, and the result carries them in grid order (``reduced``). There is
no compile cache to manage: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admm import ADMMConfig, Trace
from repro_torch.core.graph import Network, make_network
from repro_torch.core.problems import DATASETS, LeastSquaresProblem, allocate
from repro_torch.core.timing import TimingModel
from repro_torch.methods import (
    KERNELS,
    Reduction,
    get_kernel,
    run_batch,
    run_serial,
    run_sharded,
)
from repro_torch.methods.base import resolve_device
from repro_torch.methods.driver import shard_devices

MODES = ("auto", "serial", "batched", "sharded")

__all__ = ["Case", "SweepSpec", "SweepResult", "run_sweep"]

# Every registered method kernel is sweepable.
METHODS = tuple(KERNELS)


@dataclasses.dataclass(frozen=True)
class Case:
    """One fully-specified experiment run (hashable, so grids dedupe)."""

    method: str = "sI-ADMM"  # one of METHODS
    dataset: str = "usps"  # key of repro_torch.core.problems.DATASETS
    N: int = 10  # agents
    K: int = 3  # ECNs per agent
    connectivity: float = 0.5  # eta of make_network
    seed: int = 0  # drives topology, data AND schedule sampling
    iters: int = 1000
    # (c)sI-ADMM hyper-parameters (paper §V defaults)
    rho: float = 1.0
    c_tau: float = 0.5
    c_gamma: float = 1.0
    M: int = 60
    S: int = 0
    scheme: str = "uncoded"
    traversal: str = "hamiltonian"
    # gossip/first-order baseline knobs
    alpha: float = 0.05  # DGD/EXTRA step size; D-ADMM uses `rho`
    # pI-ADMM (privacy) knob
    sigma: float = 0.01  # primal perturbation std at k=1
    # cq-sI-ADMM (compressed token) knobs
    compressor: str = "topk"  # "topk" | "quant"
    frac: float = 0.25  # topk: fraction of token entries kept
    bits: int = 8  # quant: bits per transmitted entry
    # timing model (defaults mirror TimingModel so engine runs match
    # run_incremental_admm(..., straggler=None) if core defaults move)
    p_straggle: float = TimingModel.p_straggle
    delay: float = TimingModel.delay
    epsilon: float = TimingModel.epsilon
    # heterogeneous fleet (DESIGN.md §10): per-worker speed-class factors
    # (assigned round-robin) and the base response distribution
    speed_classes: Tuple[float, ...] = TimingModel.speed_classes
    response: str = TimingModel.response
    # decode deadline for partial-recovery code families (DESIGN.md §11)
    deadline: Optional[float] = TimingModel.deadline
    # event-driven mode (DESIGN.md §13): staleness bound + churn process
    tau_max: float = TimingModel.tau_max
    churn_rate: float = TimingModel.churn_rate
    mttr: float = TimingModel.mttr
    staleness_cap: int = TimingModel.staleness_cap
    # a-csI-ADMM online controller (DESIGN.md §15): the registered arm
    # set — (scheme, S, deadline) frontier cells as a hashable tuple of
    # triples — and the bandit policy selecting among them per step
    arms: Tuple[Tuple[str, int, Optional[float]], ...] = ()
    bandit: str = "ucb1"  # "ucb1" | "exp3"
    bandit_c: float = 0.5  # UCB1 confidence width
    bandit_eta: float = 0.1  # EXP3 learning rate
    bandit_gamma: float = 0.1  # EXP3 exploration mixture

    def admm_config(self) -> ADMMConfig:
        return ADMMConfig(
            rho=self.rho,
            c_tau=self.c_tau,
            c_gamma=self.c_gamma,
            M=self.M,
            K=self.K,
            S=self.S,
            scheme=self.scheme,
            exact_x=self.method == "I-ADMM",
            traversal=self.traversal,
            seed=self.seed,
        )

    def timing_model(self) -> TimingModel:
        return TimingModel(
            p_straggle=self.p_straggle,
            delay=self.delay,
            epsilon=self.epsilon,
            speed_classes=self.speed_classes,
            response=self.response,
            deadline=self.deadline,
            tau_max=self.tau_max,
            churn_rate=self.churn_rate,
            mttr=self.mttr,
            staleness_cap=self.staleness_cap,
        )

    def label(self, *fields: str) -> str:
        """Compact row label, e.g. ``csI-ADMM[S=2,seed=1]``."""
        if not fields:
            fields = ("dataset", "seed")
        kv = ",".join(f"{f}={getattr(self, f)}" for f in fields)
        return f"{self.method}[{kv}]"


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Base case + named axes = a Cartesian experiment grid.

    Axis values are either plain field values (axis name = field name) or
    dicts of several field overrides applied together (axis name is just a
    label), e.g.::

        SweepSpec("fig5", Case(dataset="synthetic", K=6, M=360),
                  axes={"S": [0, 1, 2, 3], "seed": range(4)},
                  fixup=lambda c: dataclasses.replace(
                      c, scheme="cyclic" if c.S else "uncoded"))
    """

    name: str
    base: Case
    axes: Mapping[str, Sequence] = dataclasses.field(default_factory=dict)
    fixup: Optional[Callable[[Case], Case]] = None
    description: str = ""
    # Evaluation axis of the sweep's headline reduction: None = iteration
    # index, or a cumulative Trace field ("sim_time"/"comm_cost") that
    # `reduce_mean`/`emit_rows` resample runs onto (DESIGN.md §10).
    x_axis: Optional[str] = None
    # Streaming reductions: when set, run_sweep folds these fixed-size
    # summaries into each group's step loop instead of keeping per-
    # iteration Traces — memory O(grid), the fleet-scale path. None keeps
    # the full-Trace default.
    reductions: Optional[Reduction] = None

    def cases(self) -> List[Case]:
        names = list(self.axes)
        cases: List[Case] = []
        seen = set()
        for combo in itertools.product(*(self.axes[n] for n in names)):
            c = self.base
            for name, value in zip(names, combo):
                if isinstance(value, dict):
                    c = dataclasses.replace(c, **value)
                else:
                    c = dataclasses.replace(c, **{name: value})
            if self.fixup is not None:
                c = self.fixup(c)
            if c not in seen:  # fixups may merge grid points; dedupe
                seen.add(c)
                cases.append(c)
        return cases


@dataclasses.dataclass
class SweepResult:
    """Per-case traces + how the grid was batched onto the device(s)."""

    cases: List[Case]
    traces: List[Trace]
    groups: List[Tuple[tuple, int]]  # (static signature, n_runs) per group
    wall_s: float
    mode: str = "batched"
    device: str = "cuda"
    n_devices: int = 1
    # Streaming-sweep output: flat summary dict keyed "{field}/{stat}",
    # each value a (n_cases, ...) array in grid order. Exactly one of
    # ``traces`` / ``reduced`` is populated.
    reduced: Optional[Dict[str, np.ndarray]] = None

    @property
    def n_dispatches(self) -> int:
        return len(self.groups)

    def trace(self, **filters) -> Trace:
        hits = [
            t
            for c, t in zip(self.cases, self.traces)
            if all(getattr(c, k) == v for k, v in filters.items())
        ]
        if len(hits) != 1:
            raise KeyError(f"{filters} matched {len(hits)} cases, want 1")
        return hits[0]

    def select(self, **filters) -> List[Tuple[Case, Trace]]:
        return [
            (c, t)
            for c, t in zip(self.cases, self.traces)
            if all(getattr(c, k) == v for k, v in filters.items())
        ]


# --------------------------------------------------------------------------
# Case materialization (host-side, cached within one run_sweep call)
# --------------------------------------------------------------------------


def _materialize(
    case: Case,
    net_cache: Dict[tuple, Network],
    prob_cache: Dict[tuple, LeastSquaresProblem],
) -> Tuple[Network, LeastSquaresProblem]:
    if case.dataset not in DATASETS:
        raise KeyError(
            f"unknown dataset {case.dataset!r}; known: {list(DATASETS)}"
        )
    nkey = (case.N, case.connectivity, case.seed)
    net = net_cache.get(nkey)
    if net is None:
        net = net_cache[nkey] = make_network(
            case.N, case.connectivity, seed=case.seed
        )
    pkey = (case.dataset, case.seed, case.N, case.K)
    prob = prob_cache.get(pkey)
    if prob is None:
        prob = prob_cache[pkey] = allocate(
            DATASETS[case.dataset](case.seed), case.N, case.K
        )
    return net, prob


def _signature(case: Case, prob: LeastSquaresProblem) -> tuple:
    """The kernel's static key: runs with equal keys batch together."""
    kernel = get_kernel(case.method)
    return kernel.static_signature(prob, kernel.config(case), case.iters)


def _dispatch_group(
    method: str,
    cases: List[Case],
    nets: List[Network],
    probs: List[LeastSquaresProblem],
    mode: str,
    device: torch.device,
    dtype: torch.dtype,
    reductions: Optional[Reduction] = None,
    devices: Optional[List[torch.device]] = None,
):
    """Registry lookup + the derived execution backend.

    Returns the group's per-run `Trace`s — or, with ``reductions``, one
    dict of (group_size, ...) summary arrays (serial runs are stacked
    host-side to the same shape)."""
    kernel = get_kernel(method)
    iters = cases[0].iters
    cfgs = [kernel.config(c) for c in cases]
    kw = dict(device=device, dtype=dtype)
    if mode == "serial":
        runs = [
            run_serial(kernel, p, n, cf, iters, reductions, **kw)
            for p, n, cf in zip(probs, nets, cfgs)
        ]
        if reductions is None:
            return runs
        return {k: np.stack([r[k] for r in runs]) for k in runs[0]}
    if mode == "sharded":
        return run_sharded(
            kernel, probs, nets, cfgs, iters, reductions,
            devices=devices, dtype=dtype,
        )
    return run_batch(kernel, probs, nets, cfgs, iters, reductions, **kw)


def _resolve_mode(mode: str, device: torch.device) -> str:
    """``auto`` is "sharded" iff ``device`` is CUDA and more than one CUDA
    device is visible, else "batched"."""
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode {mode!r}; known: {MODES}")
    if mode == "auto":
        many = device.type == "cuda" and torch.cuda.device_count() > 1
        return "sharded" if many else "batched"
    return mode


def _shard_devices(devices, device: torch.device) -> List[torch.device]:
    """The sharded mode's device list: ``devices`` as given, else every
    visible CUDA device when ``device`` is CUDA, else ``device`` alone."""
    if devices is None and device.type != "cuda":
        return [device]
    return shard_devices(devices)


def run_sweep(
    spec_or_cases,
    *,
    mode: str = "auto",
    reductions: Optional[Reduction] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    devices: Optional[Sequence] = None,
) -> SweepResult:
    """Execute a sweep: one step loop per static-signature group.

    Args:
      spec_or_cases: a `SweepSpec` or an explicit list of `Case`s.
      mode: "batched" (one step loop per group over a runs axis), "serial"
        (each case on its own: the same step over a runs axis of one),
        "sharded" (each group's runs axis split over ``devices``), or
        "auto" (see `_resolve_mode`).
      reductions: a `Reduction` to fold in the step loop instead of
        keeping Traces; defaults to the spec's own ``reductions`` when a
        `SweepSpec` is passed. The result then carries ``reduced``
        (grid-ordered summary arrays) and an empty ``traces``.
      device: where the device side runs (default "cuda"; raises if no
        card is present — pass "cpu" to run on the CPU).
      dtype: float dtype of the device side (torch.float32 or float64).
      devices: the sharded mode's device list (default: every visible
        CUDA device when ``device`` is CUDA, else ``device``).

    Returns a `SweepResult` with traces (or reduced summaries) in the
    original grid order.
    """
    if reductions is None and isinstance(spec_or_cases, SweepSpec):
        reductions = spec_or_cases.reductions
    cases = (
        spec_or_cases.cases()
        if isinstance(spec_or_cases, SweepSpec)
        else list(spec_or_cases)
    )
    if not cases:
        raise ValueError("empty sweep")
    device = resolve_device(device)
    mode = _resolve_mode(mode, device)
    devs = _shard_devices(devices, device) if mode == "sharded" else [device]

    t0 = time.perf_counter()
    net_cache: Dict[tuple, Network] = {}
    prob_cache: Dict[tuple, LeastSquaresProblem] = {}
    mats = [_materialize(c, net_cache, prob_cache) for c in cases]

    # Group by static signature, preserving first-seen order.
    groups: Dict[tuple, List[int]] = {}
    for idx, (case, (_net, prob)) in enumerate(zip(cases, mats)):
        groups.setdefault(_signature(case, prob), []).append(idx)

    traces: List[Optional[Trace]] = [None] * len(cases)
    rows: List[Optional[dict]] = [None] * len(cases)
    group_meta: List[Tuple[tuple, int]] = []
    for sig, idxs in groups.items():
        gcases = [cases[i] for i in idxs]
        gout = _dispatch_group(
            gcases[0].method, gcases, [mats[i][0] for i in idxs],
            [mats[i][1] for i in idxs], mode, device, dtype,
            reductions, devs,
        )
        if reductions is not None:
            # Scatter the group's (group_size, ...) summary arrays back
            # into grid order; stacked once below.
            for j, i in enumerate(idxs):
                rows[i] = {k: v[j] for k, v in gout.items()}
        else:
            for i, tr in zip(idxs, gout):
                traces[i] = tr
        group_meta.append((sig, len(idxs)))

    reduced = None
    if reductions is not None:
        keys = rows[0].keys()
        if any(r.keys() != keys for r in rows[1:]):
            raise ValueError(
                "sweep groups produced different reduction keys; all "
                "groups must share one Reduction spec"
            )
        reduced = {k: np.stack([r[k] for r in rows]) for k in keys}
        traces = []

    return SweepResult(
        cases=cases,
        traces=traces,  # type: ignore[arg-type]
        groups=group_meta,
        wall_s=time.perf_counter() - t0,
        mode=mode,
        device=str(device),
        n_devices=len(devs),
        reduced=reduced,
    )
