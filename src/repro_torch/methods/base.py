"""MethodKernel protocol: one step function per algorithm, over a runs axis.

PyTorch port of `repro.methods.base`. As in the reference, a method is a
host-side numpy ``prepare`` plus device-side ``setup``/``init``/``step``/
``final``, and the execution backends are derived from it by
`repro_torch.methods.driver`. What changes:

- ``jit`` has no counterpart: PyTorch runs eagerly, and the driver's step
  loop takes the place of ``lax.scan``.
- ``vmap`` becomes a written-out leading runs axis R. Every device-side
  method takes and returns tensors with that axis, so the step is written
  once over R and the serial driver is the R = 1 case.
- Device and dtype are explicit: `prepared_to_device` is the one place
  host arrays become tensors, on a device `resolve_device` has checked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Network
from repro_torch.core.problems import LeastSquaresProblem

__all__ = [
    "Prepared",
    "MethodKernel",
    "KERNELS",
    "register",
    "get_kernel",
    "resolve_device",
    "prepared_to_device",
]


@dataclasses.dataclass
class Prepared:
    """Host-side output of :meth:`MethodKernel.prepare` for ONE run.

    Attributes:
      consts: per-run constant arrays (data, targets, schedules' scalars).
        Stackable on a leading runs axis across a batch.
      steps: per-step input arrays, leading axis = iters (agent schedule,
        decode weights, step sizes).
      statics: values that must be identical across a batch (shapes, K,
        exact_x, iters, ...).
      max_statics: statics the batched driver reconciles with ``max()``
        across runs (e.g. the masked gather bound MU) — the corresponding
        runtime value lives in ``consts`` so runs with different values
        still share one batch.
      comm: cumulative communication units per iteration, host accounting.
      sim_time: cumulative simulated seconds per iteration.
    """

    consts: Tuple[np.ndarray, ...]
    steps: Tuple[np.ndarray, ...]
    statics: Dict[str, object]
    max_statics: Dict[str, int]
    comm: np.ndarray
    sim_time: np.ndarray


def resolve_device(device) -> torch.device:
    """``device`` as a `torch.device`; raises if it names CUDA and no card
    is present — the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def prepared_to_device(
    consts: Sequence[np.ndarray],
    steps: Sequence[np.ndarray],
    *,
    device,
    dtype: torch.dtype,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Host ``consts``/``steps`` (one run's, or stacked on a runs axis) ->
    tensors on ``device``: float arrays in ``dtype``, index arrays
    (agents, offsets, mu) in ``torch.int64``. Shapes are kept. Accepts the
    reference's ``prepare`` output as well as the port's."""
    dev = resolve_device(device)

    def convert(a) -> torch.Tensor:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, dtype=dtype, device=dev)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)
        raise TypeError(f"no device dtype for a {a.dtype} array")

    return tuple(map(convert, consts)), tuple(map(convert, steps))


class MethodKernel:
    """One algorithm = one ``step`` function plus host-side preparation.

    Subclasses implement:

    - ``config(case)``: build the method-specific config from a duck-typed
      `repro_torch.experiments.sweep.Case`.
    - ``static_signature(problem, cfg, iters)``: hashable key of everything
      that must agree within one batch; equal keys batch into one run of
      the driver.
    - ``prepare(problem, net, cfg, iters) -> Prepared``: host-side numpy.
    - ``max_statics_bound(problem, cfg, iters)``: an exact bound on
      ``Prepared.max_statics`` without preparing (default ``{}``).
    - ``setup(consts, statics) -> aux``: once per batch — derived constants
      (Gram matrices, flat views, solve operators), every tensor with a
      leading runs axis R.
    - ``init(aux, statics) -> state``: initial loop carry (a dict).
    - ``step(state, inp, aux, statics) -> (state, (acc, test_err, z_err))``:
      ONE iteration of all R runs; ``inp`` is the per-step slice of
      ``Prepared.steps`` (each tensor (R, ...)), the metrics are (R,).
    - ``final(state, aux, statics) -> (x, z)``: per-agent iterates
      (R, N, p, d) and the consensus models (R, p, d).
    """

    name: str = "?"

    def config(self, case):
        raise NotImplementedError

    def static_signature(
        self, problem: LeastSquaresProblem, cfg, iters: int
    ) -> tuple:
        raise NotImplementedError

    def prepare(
        self,
        problem: LeastSquaresProblem,
        net: Network,
        cfg,
        iters: int,
    ) -> Prepared:
        raise NotImplementedError

    def max_statics_bound(
        self, problem: LeastSquaresProblem, cfg, iters: int
    ) -> Dict[str, int]:
        """Exact bound on :attr:`Prepared.max_statics` WITHOUT preparing.

        The streaming sharded path prepares runs lazily per memory chunk,
        so the statics every chunk shares must be known up front from
        (problem, cfg) alone — ``prepare()`` would cost the very
        O(R x iters) host memory the path exists to avoid. Kernels whose
        ``prepare`` emits ``max_statics`` must override this with a value
        >= every run's prepared value (equal keys); the driver checks each
        chunk against it. Kernels with empty ``max_statics`` inherit this
        default.
        """
        return {}

    def setup(self, consts, statics):
        return consts

    def init(self, aux, statics):
        raise NotImplementedError

    def step(self, state, inp, aux, statics):
        raise NotImplementedError

    def final(self, state, aux, statics):
        raise NotImplementedError

    # -- shared aux/state/metric plumbing ----------------------------------

    @staticmethod
    def lsq_aux(O, T, x_star, O_test, T_test):
        """Aux base for kernels that keep the raw (R, N, b, ...) data views:
        everything :meth:`metrics` consumes plus shape/dtype bookkeeping."""
        R, N, b, p = O.shape
        return dict(
            O=O, T=T, b=b,
            x_star=x_star,
            xs_norm=torch.linalg.vector_norm(x_star.reshape(R, -1), dim=1),
            O_test=O_test, T_test=T_test,
            shape=(R, N, p, T.shape[3]), dtype=O.dtype,
        )

    @staticmethod
    def xyz_state(aux):
        """Zero-initialized (x, y, z) carry of the incremental-ADMM family."""
        R, N, p, d = aux["shape"]
        kw = dict(dtype=aux["dtype"], device=aux["x_star"].device)
        return dict(
            x=torch.zeros((R, N, p, d), **kw),
            y=torch.zeros((R, N, p, d), **kw),
            z=torch.zeros((R, p, d), **kw),
        )

    @staticmethod
    def metrics(x, z, aux):
        """Per-step metrics of every run (eq. 23 accuracy, test MSE, z
        error), each (R,), from aux's x_star and test-set operands: the
        Gram form where `setup` precomputed it (the ADMM family), else the
        direct residual of the raw test views (`lsq_aux`)."""
        x_star = aux["x_star"]
        R, N = x.shape[:2]
        den = aux["xs_norm"].clamp_min(1e-12)
        acc = (
            torch.linalg.vector_norm(
                (x - x_star[:, None]).reshape(R, N, -1), dim=2
            )
            / den[:, None]
        ).mean(dim=1)
        if "Gt" in aux:
            # ||O z - T||^2 / n = (z'Gz - 2<z,C> + ||T||^2) / n via the test
            # set's precomputed Gram/cross matrices (p x p per step).
            test_err = (
                torch.einsum("rpd,rpq,rqd->r", z, aux["Gt"], z)
                - 2.0 * (z * aux["Ct"]).sum(dim=(1, 2))
                + aux["TTt"]
            ) / aux["n_test"]
        else:
            r = aux["O_test"] @ z - aux["T_test"]
            test_err = (r * r).sum(dim=-1).mean(dim=-1)
        z_err = torch.linalg.vector_norm((z - x_star).reshape(R, -1), dim=1) / den
        return acc, test_err, z_err


KERNELS: Dict[str, MethodKernel] = {}


def register(kernel: MethodKernel, *names: str) -> MethodKernel:
    """Add a kernel to the method registry (name -> singleton instance).

    Extra ``names`` register the SAME instance under several method
    names (sI-/csI-/I-ADMM are one kernel whose behavior is fully
    determined by the run config), so they batch together when shapes
    allow.
    """
    for name in names or (kernel.name,):
        if name in KERNELS:
            raise ValueError(f"duplicate method kernel {name!r}")
        KERNELS[name] = kernel
    return kernel


def get_kernel(name: str) -> MethodKernel:
    if name not in KERNELS:
        raise KeyError(
            f"unknown method {name!r}; known: {sorted(KERNELS)}"
        )
    return KERNELS[name]
