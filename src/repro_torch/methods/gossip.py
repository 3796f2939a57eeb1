"""Gossip baselines (D-ADMM, DGD, EXTRA) as MethodKernels (paper §V-A).

PyTorch port of `repro.methods.gossip`. Every agent updates every
iteration using all its neighbors — 2|E| directed messages per iteration
versus the incremental methods' single token hop. All three consume full
local gradients, as in the original methods; the consensus model reported
in metrics is the agent mean. No gossip method calls a kernel of the port:
their steps are mixing products, local gradients and (D-ADMM) a batched
solve, as in the reference.

Simulated wall-clock: a round costs the slowest agent's compute plus its
serialized per-neighbor link transfers (`TimingModel.gossip_round_times`),
drawn host-side on the composite seed stream [4, seed], bit for bit the
reference's. The device step runs over a leading runs axis R: the
reference's ``einsum("ij,jpd->ipd")`` of one run becomes
``einsum("rij,rjpd->ripd")``.

Only the synchronous path is ported: a timing model that ``is_async``
raises (ROADMAP Queue 1, item 11, with the delayed-broadcast history
rings).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import Network, metropolis_weights
from repro_torch.core.problems import LeastSquaresProblem
from repro_torch.core.timing import TimingModel

from .base import MethodKernel, Prepared, register

__all__ = [
    "GossipRun",
    "DADMM",
    "DGD",
    "EXTRA",
    "D_ADMM_K",
    "DGD_K",
    "EXTRA_K",
]


@dataclasses.dataclass(frozen=True)
class GossipRun:
    """Per-run config of a gossip baseline: step parameter + clock.

    ``param`` is rho for D-ADMM and alpha for DGD/EXTRA; ``seed`` drives
    the host-side timing draws (topology/data sampling stays with the
    problem, as everywhere else).
    """

    param: float
    diminishing: bool = False  # DGD: alpha_k = param / sqrt(k)
    timing: Optional[TimingModel] = None
    seed: int = 0


def _lsq_consts(problem: LeastSquaresProblem, mix: np.ndarray, *scalars):
    dt = problem.O.dtype
    return (
        problem.O,
        problem.T,
        mix.astype(dt),
        problem.x_star().astype(dt),
        problem.O_test,
        problem.T_test,
        *(np.asarray(s, dtype=dt) for s in scalars),
    )


def _mix(W, x):
    """Per-run mixing: W (R, N, N) applied over agents of x (R, N, p, d)."""
    return torch.einsum("rij,rjpd->ripd", W, x)


class _GossipKernel(MethodKernel):
    """Shared shape/metric/timing plumbing for all-agents-per-step methods."""

    def static_signature(
        self, problem: LeastSquaresProblem, run, iters: int
    ) -> tuple:
        return (
            self.name,
            problem.N, problem.b, problem.p, problem.d,
            problem.O_test.shape[0], iters,
        )

    def _prepared(self, problem, net: Network, run: GossipRun, iters: int,
                  consts: tuple, steps: tuple = ()) -> Prepared:
        """The host-side clock (stream [4, seed]) and comm count of a
        synchronous gossip run around the method's consts and steps."""
        timing = run.timing or TimingModel()
        if timing.is_async:
            raise NotImplementedError(
                "event-driven timing (tau_max > 0 or churn_rate > 0) is not "
                "ported yet: ROADMAP Queue 1, item 11 (async mode)"
            )
        rng = np.random.default_rng([4, run.seed])
        return Prepared(
            consts=consts,
            steps=steps,
            statics=dict(name=self.name, iters=iters),
            max_statics={},
            comm=np.cumsum(np.full(iters, 2.0 * net.E)),
            sim_time=np.cumsum(timing.gossip_round_times(net, iters, rng)),
        )

    def _grad(self, aux, x):
        """Stacked full local gradients (R, N, p, d)."""
        O, T = aux["O"], aux["T"]
        return (
            torch.einsum(
                "rnbp,rnbd->rnpd", O,
                torch.einsum("rnbp,rnpd->rnbd", O, x) - T,
            )
            / aux["b"]
        )

    def final(self, state, aux, statics):
        x = state["x"]
        return x, x.mean(dim=1)


class DADMM(_GossipKernel):
    """Gossip decentralized consensus ADMM [14]/[9] (exact local solves)."""

    name = "D-ADMM"

    def config(self, case) -> GossipRun:
        return GossipRun(
            case.rho, timing=case.timing_model(), seed=case.seed
        )

    def prepare(self, problem, net: Network, run: GossipRun, iters: int):
        dt = problem.O.dtype
        consts = (
            problem.O,
            problem.T,
            net.adjacency.astype(dt),
            net.degree().astype(dt),
            problem.x_star().astype(dt),
            problem.O_test,
            problem.T_test,
            np.asarray(run.param, dtype=dt),
        )
        return self._prepared(problem, net, run, iters, consts)

    def setup(self, consts, statics):
        O, T, A, deg, x_star, O_test, T_test, rho = consts
        aux = self.lsq_aux(O, T, x_star, O_test, T_test)
        b, p = O.shape[2], O.shape[3]
        H = torch.einsum("rnbp,rnbq->rnpq", O, O) / b
        eye = torch.eye(p, dtype=O.dtype, device=O.device)
        aux.update(
            A=A, deg=deg[:, :, None, None], rho=rho[:, None, None, None],
            rhs0=torch.einsum("rnbp,rnbd->rnpd", O, T) / b,
            # Per-agent solve operator: (H_i + 2 rho d_i I)
            Hs=H + 2.0 * rho[:, None, None, None] * deg[:, :, None, None] * eye,
        )
        return aux

    def init(self, aux, statics):
        zeros = torch.zeros(
            aux["shape"], dtype=aux["dtype"], device=aux["x_star"].device
        )
        return dict(x=zeros, alpha=zeros.clone())

    def step(self, state, inp, aux, statics):
        x, alpha = state["x"], state["alpha"]
        A, deg, rho = aux["A"], aux["deg"], aux["rho"]
        rhs = aux["rhs0"] + rho * (deg * x + _mix(A, x)) - alpha
        x_new = torch.linalg.solve(aux["Hs"], rhs)
        alpha = alpha + rho * (deg * x_new - _mix(A, x_new))
        state = dict(x=x_new, alpha=alpha)
        return state, self.metrics(x_new, x_new.mean(dim=1), aux)


class DGD(_GossipKernel):
    """Decentralized gradient descent [6] with Metropolis mixing."""

    name = "DGD"

    def config(self, case) -> GossipRun:
        return GossipRun(
            case.alpha, diminishing=True,
            timing=case.timing_model(), seed=case.seed,
        )

    def prepare(self, problem, net: Network, run: GossipRun, iters: int):
        steps = (
            run.param / np.sqrt(np.arange(1, iters + 1))
            if run.diminishing
            else np.full(iters, run.param)
        )
        return self._prepared(
            problem, net, run, iters,
            _lsq_consts(problem, metropolis_weights(net)),
            (steps.astype(problem.O.dtype),),
        )

    def setup(self, consts, statics):
        O, T, W, x_star, O_test, T_test = consts
        aux = self.lsq_aux(O, T, x_star, O_test, T_test)
        aux["W"] = W
        return aux

    def init(self, aux, statics):
        return dict(x=torch.zeros(
            aux["shape"], dtype=aux["dtype"], device=aux["x_star"].device
        ))

    def step(self, state, inp, aux, statics):
        x = state["x"]
        (alpha,) = inp
        x_new = _mix(aux["W"], x) - alpha[:, None, None, None] * self._grad(aux, x)
        return dict(x=x_new), self.metrics(x_new, x_new.mean(dim=1), aux)


class EXTRA(_GossipKernel):
    """EXTRA [7]: exact first-order gossip with constant step size."""

    name = "EXTRA"

    def config(self, case) -> GossipRun:
        return GossipRun(
            case.alpha, timing=case.timing_model(), seed=case.seed
        )

    def prepare(self, problem, net: Network, run: GossipRun, iters: int):
        return self._prepared(
            problem, net, run, iters,
            _lsq_consts(problem, metropolis_weights(net), run.param),
        )

    def setup(self, consts, statics):
        O, T, W, x_star, O_test, T_test, alpha = consts
        aux = self.lsq_aux(O, T, x_star, O_test, T_test)
        eye = torch.eye(O.shape[1], dtype=O.dtype, device=O.device)
        aux.update(
            W=W, alpha=alpha[:, None, None, None],
            I_plus_W=eye + W, W_tilde=0.5 * (eye + W),
        )
        return aux

    def init(self, aux, statics):
        x0 = torch.zeros(
            aux["shape"], dtype=aux["dtype"], device=aux["x_star"].device
        )
        x1 = _mix(aux["W"], x0) - aux["alpha"] * self._grad(aux, x0)
        return dict(x_prev=x0, x=x1)

    def step(self, state, inp, aux, statics):
        x_prev, x_cur = state["x_prev"], state["x"]
        x_next = (
            _mix(aux["I_plus_W"], x_cur)
            - _mix(aux["W_tilde"], x_prev)
            - aux["alpha"] * (self._grad(aux, x_cur) - self._grad(aux, x_prev))
        )
        state = dict(x_prev=x_cur, x=x_next)
        return state, self.metrics(x_next, x_next.mean(dim=1), aux)


D_ADMM_K = register(DADMM())
DGD_K = register(DGD())
EXTRA_K = register(EXTRA())
