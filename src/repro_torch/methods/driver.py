"""Execution backends derived from a MethodKernel.

PyTorch port of `repro.methods.driver`. The step is written once over a
leading runs axis R (`repro_torch.methods.base`), and every backend runs
the same loop over it:

- ``run_batch`` prepares R runs host-side, stacks them on the runs axis,
  and runs them together;
- ``run_serial`` is the R = 1 case of the same path;
- ``run_sharded`` splits the runs axis over a list of devices (by
  default every visible CUDA device): the runs are padded to a multiple
  of the device count D by repeating the last run, cut into D shards
  that step in lockstep from one host loop (so the devices' queues fill
  together), and chunked under the ``REPRO_SHARD_MEM_MB`` per-device
  budget. No operation crosses the runs axis, so each run's arithmetic
  is that of `run_batch`. With one device, or one run, it is exactly
  `run_batch`.

All step inputs move to the device once, as (R, iters, ...) tensors; the
loop does no host synchronisation. Without ``reductions`` the per-step
metrics are stacked on the device and copied to the host once at the end
(a `Trace` per run). With a `Reduction` the metrics feed its fixed-size
carry instead, with the cumulative sim_time/comm_cost clock as the LAST
step input (`_clock_steps`), and only the summaries leave the device: a
dict of (R, ...) numpy arrays. ``lax.scan`` becomes the Python loop of
`run_steps`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admm import Trace
from repro_torch.core.graph import Network
from repro_torch.core.problems import LeastSquaresProblem

from .base import MethodKernel, Prepared, prepared_to_device, resolve_device
from .reductions import Reduction

__all__ = ["run_serial", "run_batch", "run_sharded", "run_steps"]

DTYPES = (torch.float32, torch.float64)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"run dtype must be one of {DTYPES}, got {dtype}")


def run_steps(
    kernel: MethodKernel,
    statics: dict,
    consts: Tuple[torch.Tensor, ...],
    steps: Tuple[torch.Tensor, ...],
    reductions: Optional[Reduction] = None,
):
    """setup -> init -> loop(step) -> final over device tensors.

    ``consts`` are (R, ...) and ``steps`` (R, iters, ...) tensors on one
    device (see `prepared_to_device`). Returns device tensors
    ``(x (R, N, p, d), z (R, p, d), (acc, test_err, z_err))`` with each
    metric (R, iters) — or, with ``reductions`` (and the (R, iters, 2)
    clock increments as the last of ``steps``), the summary dict of
    (R, ...) device tensors.
    """
    return _run_shards(kernel, statics, [(consts, steps)], reductions)[0]


def _run_shards(kernel, statics, shards, reductions=None) -> list:
    """`run_steps` of several shards, each on its own device, stepped in
    lockstep: iteration k of every shard is queued before iteration k + 1
    of any, so the devices work at the same time."""
    with torch.inference_mode():
        loops = []
        for consts, steps in shards:
            aux = kernel.setup(consts, statics)
            # Iteration-major copies, so each step's slice is a contiguous
            # (R, ...) view.
            steps = tuple(s.transpose(0, 1).contiguous() for s in steps)
            loop = dict(aux=aux, state=kernel.init(aux, statics), metrics=[])
            if reductions is not None:
                *steps, loop["clock"] = steps
                loop["red"] = reductions.init_carry(
                    loop["clock"].shape[1], loop["clock"].dtype,
                    loop["clock"].device,
                )
            loop["steps"] = tuple(steps)
            loops.append(loop)
        for k in range(statics["iters"]):
            for loop in loops:
                loop["state"], m = kernel.step(
                    loop["state"], tuple(s[k] for s in loop["steps"]),
                    loop["aux"], statics,
                )
                if reductions is None:
                    loop["metrics"].append(m)
                else:
                    loop["red"] = reductions.update_carry(
                        loop["red"], m, loop["clock"][k]
                    )
        outs = []
        for loop in loops:
            if reductions is None:
                x, z = kernel.final(loop["state"], loop["aux"], statics)
                metrics = loop["metrics"]
                outs.append((x, z, tuple(
                    torch.stack([m[j] for m in metrics], dim=1)
                    for j in range(3)
                )))
                continue
            out = reductions.finalize_carry(loop["red"])
            if reductions.final_x:
                out["final_x"], out["final_z"] = kernel.final(
                    loop["state"], loop["aux"], statics
                )
            outs.append(out)
    return outs


def _clock_steps(prep: Prepared) -> np.ndarray:
    """(iters, 2) per-step [d_sim_time, d_comm] increments of the host
    clocks, ordered as `repro_torch.methods.reductions.CLOCK_AXES`."""
    return np.stack(
        [
            np.diff(prep.sim_time, prepend=0.0),
            np.diff(np.asarray(prep.comm, dtype=np.float64), prepend=0.0),
        ],
        axis=1,
    )


def _stack(preps: Sequence[Prepared], reductions=None):
    """Stack R runs' host arrays on a leading runs axis; with
    ``reductions``, the clock increments are the last step input."""
    consts = tuple(
        np.stack([np.asarray(pr.consts[i]) for pr in preps])
        for i in range(len(preps[0].consts))
    )
    steps = tuple(
        np.stack([np.asarray(pr.steps[i]) for pr in preps])
        for i in range(len(preps[0].steps))
    )
    if reductions is not None:
        steps += (np.stack([_clock_steps(pr) for pr in preps]),)
    return consts, steps


def _to_host(out: dict) -> Dict[str, np.ndarray]:
    """A summary dict of device tensors as numpy arrays."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def _traces(preps: Sequence[Prepared], x, z, acc, test_err, z_err) -> List[Trace]:
    """Per-run `Trace`s from host arrays with a leading runs axis."""
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


def _run_prepared(
    kernel: MethodKernel,
    preps: Sequence[Prepared],
    statics: dict,
    device: torch.device,
    dtype: torch.dtype,
    reductions: Optional[Reduction] = None,
):
    consts, steps = prepared_to_device(
        *_stack(preps, reductions), device=device, dtype=dtype
    )
    out = run_steps(kernel, statics, consts, steps, reductions)
    if reductions is not None:
        return _to_host(out)
    x, z, metrics = out
    # One host copy of each output, after the whole loop.
    return _traces(preps, *(t.cpu().numpy() for t in (x, z) + metrics))


def run_serial(
    kernel: MethodKernel,
    problem: LeastSquaresProblem,
    net: Network,
    cfg,
    iters: int,
    reductions: Optional[Reduction] = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """One run: the R = 1 case of `run_batch`'s path. Returns a `Trace`,
    or — with ``reductions`` — the run's summary dict of numpy arrays."""
    _check_dtype(dtype)
    device = resolve_device(device)
    prep = kernel.prepare(problem, net, cfg, iters)
    statics = {**prep.statics, **prep.max_statics}
    out = _run_prepared(kernel, [prep], statics, device, dtype, reductions)
    if reductions is not None:
        return {k: v[0] for k, v in out.items()}
    return out[0]


def _check_signatures(kernel, problems, cfgs, iters) -> None:
    sigs = {
        kernel.static_signature(p, c, iters)
        for p, c in zip(problems, cfgs)
    }
    if len(sigs) != 1:
        raise ValueError(
            f"batch mixes {len(sigs)} static signatures; group runs by "
            f"{kernel.name} static_signature() first"
        )


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
    _check_signatures(kernel, problems, cfgs, iters)
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
    reductions: Optional[Reduction] = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """R runs on one leading runs axis: one step loop for all of them.

    Returns per-run `Trace`s, or — with ``reductions`` — one dict of
    numpy arrays with a leading runs axis."""
    _check_dtype(dtype)
    device = resolve_device(device)
    preps, statics = _stack_batch(kernel, problems, nets, cfgs, iters)
    return _run_prepared(kernel, preps, statics, device, dtype, reductions)


# --------------------------------------------------------------------------
# The runs axis over several devices
# --------------------------------------------------------------------------

# Per-device working-set budget for one chunk, in MiB: the reference's
# own variable and default. The rule is deliberately coarse (inputs +
# outputs + a 2x slack factor for temporaries); it only needs to keep a
# huge grid from exhausting a device, not to model the allocator.
_MEM_BUDGET_ENV = "REPRO_SHARD_MEM_MB"
_DEFAULT_MEM_MB = 4096


def _bytes_per_run(
    consts, steps, statics: dict, preps: List[Prepared]
) -> int:
    """Estimated per-run device footprint: stacked inputs + loop outputs."""
    R = len(preps)
    in_bytes = sum(a.nbytes for a in consts + steps) // max(R, 1)
    iters = int(statics.get("iters", 1))
    # x/z outputs mirror the largest const (the data block); metrics are
    # 3 float traces of length iters.
    out_bytes = 3 * iters * 8
    for a in consts:
        out_bytes += a.nbytes // max(R, 1)
    return max(in_bytes + out_bytes, 1)


def _chunk_runs(R_pad: int, D: int, per_run_bytes: int) -> int:
    """Largest run count per chunk within the per-device budget, a
    multiple of the device count D (so every chunk shards evenly)."""
    budget = int(os.environ.get(_MEM_BUDGET_ENV, _DEFAULT_MEM_MB)) * 2**20
    fit = (budget * D) // (2 * per_run_bytes)  # 2x slack for temporaries
    chunk = max(D, (fit // D) * D)
    return min(chunk, R_pad)


def shard_devices(devices) -> List[torch.device]:
    """The sharded tier's device list: ``devices`` as given (checked), or
    every visible CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_sharded with no devices= needs CUDA devices, and "
                "torch.cuda.is_available() is False; pass devices=['cpu', ...]"
            )
        return [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("run_sharded needs at least one device")
    return devs


def _pad_runs(arrays: Tuple[np.ndarray, ...], pad: int):
    """Repeat the last run ``pad`` times (its outputs are sliced off)."""
    if not pad:
        return arrays
    return tuple(
        np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrays
    )


def _run_chunk(kernel, statics, consts, steps, devs, dtype, reductions):
    """One chunk of n runs (host arrays) over the D devices: pad to a
    multiple of D, one equal shard per device, lockstep loop. Returns the
    shards' outputs concatenated on the host, padding dropped: a summary
    dict, or (x, z, acc, test_err, z_err) numpy arrays."""
    n, D = consts[0].shape[0], len(devs)
    pad = -(-n // D) * D - n
    consts, steps = _pad_runs(consts, pad), _pad_runs(steps, pad)
    per = (n + pad) // D
    shards = []
    for j, dev in enumerate(devs):
        sl = slice(j * per, (j + 1) * per)
        shards.append(prepared_to_device(
            tuple(a[sl] for a in consts), tuple(a[sl] for a in steps),
            device=dev, dtype=dtype,
        ))
    outs = _run_shards(kernel, statics, shards, reductions)
    if reductions is not None:
        host = [_to_host(o) for o in outs]
        return {k: np.concatenate([h[k] for h in host])[:n] for k in host[0]}
    x, z, metrics = zip(*outs)
    acc, te, ze = zip(*metrics)
    return tuple(
        torch.cat([t.cpu() for t in parts]).numpy()[:n]
        for parts in (x, z, acc, te, ze)
    )


def _run_reduced_chunked(
    kernel: MethodKernel,
    problems: Sequence[LeastSquaresProblem],
    nets: Sequence[Network],
    cfgs: Sequence,
    iters: int,
    spec: Reduction,
    devs: List[torch.device],
    dtype: torch.dtype,
) -> Dict[str, np.ndarray]:
    """Streaming sharded execution with LAZY per-chunk prepare.

    The eager path prepares and stacks all R runs before the loop —
    host memory O(R x iters) even though the outputs are O(R). Here runs
    are prepared only when their chunk runs, so peak host memory is
    O(chunk x iters) + O(R x spec): the chunk size shrinks as per-run
    schedules grow (`_chunk_runs` on the prepared bytes of run 0).
    Requires the kernel's `max_statics_bound` to hold for every run, so
    that every chunk runs under ONE set of statics; a chunk that exceeds
    it raises.
    """
    D = len(devs)
    _check_signatures(kernel, problems, cfgs, iters)
    bound: Dict[str, int] = {}
    for p, c in zip(problems, cfgs):
        for key, val in kernel.max_statics_bound(p, c, iters).items():
            bound[key] = max(bound.get(key, 0), int(val))

    # One probe prepare: fixes the shared statics and sizes the chunks.
    prep0 = kernel.prepare(problems[0], nets[0], cfgs[0], iters)
    if set(prep0.max_statics) != set(bound):
        raise ValueError(
            f"{kernel.name}.max_statics_bound() keys {sorted(bound)} != "
            f"prepared max_statics keys {sorted(prep0.max_statics)}; "
            "implement the bound hook for chunked streaming execution"
        )
    statics = {**prep0.statics, **bound}
    per_run = (
        sum(np.asarray(a).nbytes for a in prep0.consts + prep0.steps)
        + _clock_steps(prep0).nbytes
    )
    del prep0  # the probe's schedules are re-prepared with its chunk
    R = len(problems)
    chunk = _chunk_runs(-(-R // D) * D, D, max(per_run, 1))
    outs: List[Dict[str, np.ndarray]] = []
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        preps = [
            kernel.prepare(p, n, c, iters)
            for p, n, c in zip(problems[lo:hi], nets[lo:hi], cfgs[lo:hi])
        ]
        for pr in preps:
            if pr.statics != _shared_statics(statics, pr):
                raise ValueError("equal signatures produced unequal statics")
            for key, val in pr.max_statics.items():
                if int(val) > statics[key]:
                    raise ValueError(
                        f"{kernel.name}.max_statics_bound() under-bounds "
                        f"{key}: prepared {val} > bound {statics[key]}"
                    )
        consts, steps = _stack(preps, spec)
        del preps
        outs.append(
            _run_chunk(kernel, statics, consts, steps, devs, dtype, spec)
        )
        # Free this chunk's host arrays before the next chunk's prepare.
        del consts, steps
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _shared_statics(statics: dict, prep: Prepared) -> dict:
    """The statics a chunked run must agree on: everything but the
    max-reconciled keys (whose runtime values legitimately differ)."""
    return {k: v for k, v in statics.items() if k not in prep.max_statics}


def run_sharded(
    kernel: MethodKernel,
    problems: Sequence[LeastSquaresProblem],
    nets: Sequence[Network],
    cfgs: Sequence,
    iters: int,
    reductions: Optional[Reduction] = None,
    *,
    devices: Optional[Sequence] = None,
    dtype: torch.dtype = torch.float32,
):
    """R runs on a runs axis split over ``devices`` (default: every
    visible CUDA device; a device may be listed more than once).

    The runs are padded to a multiple of D = len(devices) by repeating
    the last run (its outputs are dropped), cut into chunks under the
    ``REPRO_SHARD_MEM_MB`` per-device budget, and each chunk into D equal
    shards that step in lockstep. Returns per-run `Trace`s, equal to
    `run_batch`'s where the devices compute a run's arithmetic the same
    way at every batch size. With one device, or one run, it is
    `run_batch` on that device.

    With ``reductions`` set, the runs are prepared lazily per chunk
    (`_run_reduced_chunked`) and the return value is one dict of (R, ...)
    numpy arrays.
    """
    _check_dtype(dtype)
    devs = shard_devices(devices)
    if len(devs) == 1 or len(problems) == 1:
        # One device means nothing to lay out; one run means padding
        # would make every device compute a duplicate of the same run.
        return run_batch(
            kernel, problems, nets, cfgs, iters, reductions=reductions,
            device=devs[0], dtype=dtype,
        )
    if reductions is not None:
        return _run_reduced_chunked(
            kernel, problems, nets, cfgs, iters, reductions, devs, dtype
        )
    preps, statics = _stack_batch(kernel, problems, nets, cfgs, iters)
    consts, steps = _stack(preps)
    R, D = len(preps), len(devs)
    chunk = _chunk_runs(
        -(-R // D) * D, D, _bytes_per_run(consts, steps, statics, preps)
    )
    outs = [
        _run_chunk(
            kernel, statics, tuple(a[lo:lo + chunk] for a in consts),
            tuple(a[lo:lo + chunk] for a in steps), devs, dtype, None,
        )
        for lo in range(0, R, chunk)
    ]
    return _traces(
        preps, *(np.concatenate([o[i] for o in outs]) for i in range(5))
    )
