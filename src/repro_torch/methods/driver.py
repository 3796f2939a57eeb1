"""Execution backends derived from a MethodKernel.

PyTorch port of `repro.methods.driver`. The step is written once over a
leading runs axis R (`repro_torch.methods.base`), and both backends run
the same loop over it:

- ``run_batch`` prepares R runs host-side, stacks them on the runs axis,
  and runs them together;
- ``run_serial`` is the R = 1 case of the same path.

All step inputs move to the device once, as (R, iters, ...) tensors; the
loop does no host synchronisation, and the per-step metrics are stacked on
the device and copied to the host once at the end. ``lax.scan`` becomes
the Python loop of `run_steps`. Streaming reductions (``reductions=``,
ROADMAP Queue 1 item 10) and the mesh-sharded tier (``run_sharded``,
item 13) are not ported yet and raise.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admm import Trace
from repro_torch.core.graph import Network
from repro_torch.core.problems import LeastSquaresProblem

from .base import MethodKernel, Prepared, prepared_to_device, resolve_device

__all__ = ["run_serial", "run_batch", "run_sharded", "run_steps"]

DTYPES = (torch.float32, torch.float64)


def _not_ported_reductions(reductions) -> None:
    if reductions is not None:
        raise NotImplementedError(
            "streaming reductions (reductions=) are not ported yet: "
            "ROADMAP Queue 1, item 10"
        )


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"run dtype must be one of {DTYPES}, got {dtype}")


def run_steps(
    kernel: MethodKernel,
    statics: dict,
    consts: Tuple[torch.Tensor, ...],
    steps: Tuple[torch.Tensor, ...],
):
    """setup -> init -> loop(step) -> final over device tensors.

    ``consts`` are (R, ...) and ``steps`` (R, iters, ...) tensors on one
    device (see `prepared_to_device`). Returns device tensors
    ``(x (R, N, p, d), z (R, p, d), (acc, test_err, z_err))`` with each
    metric (R, iters).
    """
    with torch.inference_mode():
        aux = kernel.setup(consts, statics)
        state = kernel.init(aux, statics)
        # Iteration-major copies, so each step's slice is a contiguous
        # (R, ...) view.
        steps = tuple(s.transpose(0, 1).contiguous() for s in steps)
        metrics: List[tuple] = []
        for k in range(statics["iters"]):
            state, m = kernel.step(
                state, tuple(s[k] for s in steps), aux, statics
            )
            metrics.append(m)
        x, z = kernel.final(state, aux, statics)
        stacked = tuple(
            torch.stack([m[j] for m in metrics], dim=1) for j in range(3)
        )
    return x, z, stacked


def _stack(preps: Sequence[Prepared]):
    """Stack R runs' host arrays on a leading runs axis."""
    consts = tuple(
        np.stack([np.asarray(pr.consts[i]) for pr in preps])
        for i in range(len(preps[0].consts))
    )
    steps = tuple(
        np.stack([np.asarray(pr.steps[i]) for pr in preps])
        for i in range(len(preps[0].steps))
    )
    return consts, steps


def _run_prepared(
    kernel: MethodKernel,
    preps: Sequence[Prepared],
    statics: dict,
    device: torch.device,
    dtype: torch.dtype,
) -> List[Trace]:
    consts, steps = prepared_to_device(
        *_stack(preps), device=device, dtype=dtype
    )
    x, z, metrics = run_steps(kernel, statics, consts, steps)
    # One host copy of each output, after the whole loop.
    x, z, acc, test_err, z_err = (
        t.cpu().numpy() for t in (x, z) + metrics
    )
    return [
        Trace(
            accuracy=acc[r],
            test_error=test_err[r],
            comm_cost=pr.comm,
            sim_time=pr.sim_time,
            z_err=z_err[r],
            final_x=x[r],
            final_z=z[r],
        )
        for r, pr in enumerate(preps)
    ]


def run_serial(
    kernel: MethodKernel,
    problem: LeastSquaresProblem,
    net: Network,
    cfg,
    iters: int,
    reductions=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Trace:
    """One run: the R = 1 case of `run_batch`'s path."""
    _not_ported_reductions(reductions)
    _check_dtype(dtype)
    device = resolve_device(device)
    prep = kernel.prepare(problem, net, cfg, iters)
    statics = {**prep.statics, **prep.max_statics}
    return _run_prepared(kernel, [prep], statics, device, dtype)[0]


def _stack_batch(
    kernel: MethodKernel,
    problems: Sequence[LeastSquaresProblem],
    nets: Sequence[Network],
    cfgs: Sequence,
    iters: int,
) -> Tuple[List[Prepared], dict]:
    """Prepare R runs that share one static signature (host-side).

    ``max_statics`` (e.g. the masked gather bound MU) are reconciled with
    ``max`` so runs whose *runtime* value differs (mixed straggler
    tolerance S in a fig5 grid) still share the batch. Raises ValueError on
    mixed statics — `repro_torch.experiments.sweep.run_sweep` groups by
    signature first.
    """
    R = len(problems)
    if not (len(nets) == len(cfgs) == R):
        raise ValueError("problems, nets, cfgs must have equal length")
    sigs = {
        kernel.static_signature(p, c, iters)
        for p, c in zip(problems, cfgs)
    }
    if len(sigs) != 1:
        raise ValueError(
            f"batch mixes {len(sigs)} static signatures; group runs by "
            f"{kernel.name} static_signature() first"
        )
    preps = [
        kernel.prepare(p, n, c, iters)
        for p, n, c in zip(problems, nets, cfgs)
    ]
    statics = dict(preps[0].statics)
    if any(pr.statics != statics for pr in preps[1:]):
        raise ValueError("equal signatures produced unequal statics")
    for key in preps[0].max_statics:
        statics[key] = max(pr.max_statics[key] for pr in preps)
    return preps, statics


def run_batch(
    kernel: MethodKernel,
    problems: Sequence[LeastSquaresProblem],
    nets: Sequence[Network],
    cfgs: Sequence,
    iters: int,
    reductions=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> List[Trace]:
    """R runs on one leading runs axis: one step loop for all of them.
    Returns per-run `Trace`s."""
    _not_ported_reductions(reductions)
    _check_dtype(dtype)
    device = resolve_device(device)
    preps, statics = _stack_batch(kernel, problems, nets, cfgs, iters)
    return _run_prepared(kernel, preps, statics, device, dtype)


def run_sharded(*args, **kwargs):
    """The mesh-sharded tier is not ported yet (ROADMAP Queue 1, item 13)."""
    raise NotImplementedError(
        "run_sharded (runs axis across CUDA devices) is not ported yet: "
        "ROADMAP Queue 1, item 13"
    )
