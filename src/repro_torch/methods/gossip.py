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

Event-driven mode: when the run's `TimingModel.is_async`, each kernel
switches to a delayed-broadcast model. Agents publish their iterates into
a depth-D history ring in the carry, (R, D, N, p, d); each round, agent
j's *published* value is read at a per-agent staleness ``delta[k, j]``
drawn host-side against the run's cumulative clock (``staleness_steps``),
while gradients are always taken at the agent's own fresh iterate.
Crashed agents (``sample_churn``, seed stream [6, seed]; staleness uses
[7, seed]) hold their own iterate, and their last published value stays
in their neighbours' mixing. ``delta = 0`` reads the previous round's
publication — exactly the current iterate — so all three methods
degenerate to the synchronous iterates (D-ADMM through its dual-first
async form). Sync runs keep the exact pre-async signature, draws and
steps.
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


def _solve(H, rhs):
    """D-ADMM's batched x-solve. ``solve_ex`` is ``solve`` without its
    singularity check, which waits for the card every step; each H is
    positive definite, and the result is the same bits."""
    return torch.linalg.solve_ex(H, rhs).result


def _gate(act):
    """(R, N) activity -> (R, N, 1, 1) live mask."""
    return act[:, :, None, None] > 0


class _GossipKernel(MethodKernel):
    """Shared shape/metric/timing plumbing for all-agents-per-step methods."""

    # How many past publications a step reads per agent: 1 for the
    # one-round-back mixing of DGD/D-ADMM, 2 for EXTRA's two-term
    # recursion. Staleness is clipped to D - _ages so the oldest read is
    # still live in the depth-D ring.
    _ages = 1

    def static_signature(
        self, problem: LeastSquaresProblem, run, iters: int
    ) -> tuple:
        sig = (
            self.name,
            problem.N, problem.b, problem.p, problem.d,
            problem.O_test.shape[0], iters,
        )
        timing = run.timing or TimingModel()
        if timing.is_async:
            sig = sig + ("async", timing.staleness_cap)
        return sig

    def _event_schedules(self, run: GossipRun, net: Network, iters: int, dt):
        """Host-side clock + async step inputs.

        Returns ``(sim_time, extra_steps, extra_statics)``. Synchronous
        runs take the exact pre-async draw path (same rng stream [4,
        seed], same call sequence), so their clock and signature are
        those of the sync-only port.
        """
        timing = run.timing or TimingModel()
        rng = np.random.default_rng([4, run.seed])
        if not timing.is_async:
            sim = np.cumsum(timing.gossip_round_times(net, iters, rng))
            return sim, (), {}
        comp, per_agent = timing.gossip_components(net, iters, rng)
        nominal = timing.gossip_round_from(comp, per_agent)
        up = np.ones((iters, net.N), dtype=bool)
        if timing.churn_rate > 0:
            # Churn is evaluated at iteration start times on the
            # churn-free provisional clock (one-way coupling).
            starts = np.concatenate([[0.0], np.cumsum(nominal)[:-1]])
            up = timing.sample_churn(
                starts, net.N, np.random.default_rng([6, run.seed])
            )
        sim_time = np.cumsum(
            timing.gossip_round_from(comp, per_agent, alive=up)
        )
        D = timing.staleness_cap
        delta = timing.staleness_steps(
            sim_time, np.random.default_rng([7, run.seed]), n=net.N
        )
        delta = np.minimum(delta, D - self._ages)
        k = np.arange(iters)
        # Read slots oldest-first (EXTRA reads age 2 then age 1); the
        # publication of round k lands in slot k % D after all reads.
        rslots = tuple(
            ((k[:, None] - a - delta) % D).astype(np.int32)
            for a in range(self._ages, 0, -1)
        )
        steps = ((k % D).astype(np.int32),) + rslots + (up.astype(dt),)
        return sim_time, steps, dict(ASYNC=True, D=D)

    def _prepared(self, problem, net: Network, run: GossipRun, iters: int,
                  consts: tuple, steps: tuple = ()) -> Prepared:
        """The host-side clock and comm count of a gossip run around the
        method's consts and steps (the async inputs appended last)."""
        sim_time, extra, extra_statics = self._event_schedules(
            run, net, iters, problem.O.dtype
        )
        return Prepared(
            consts=consts,
            steps=steps + extra,
            statics=dict(name=self.name, iters=iters, **extra_statics),
            max_statics={},
            comm=np.cumsum(np.full(iters, 2.0 * net.E)),
            sim_time=sim_time,
        )

    @staticmethod
    def _hist(aux, statics):
        """Zeroed (R, D, N, p, d) history ring of published iterates."""
        R, N, p, d = aux["shape"]
        return torch.zeros(
            (R, statics["D"], N, p, d), dtype=aux["dtype"],
            device=aux["x_star"].device,
        )

    @staticmethod
    def _published(hist, rslot):
        """Per-agent stale reads: hist (R, D, N, p, d), rslot (R, N) ->
        (R, N, p, d)."""
        R, N = rslot.shape
        runs = torch.arange(R, device=hist.device)[:, None]
        agents = torch.arange(N, device=hist.device)[None, :]
        return hist[runs, rslot, agents]

    @staticmethod
    def _publish(hist, wslot, x):
        """Write every run's round publication at its slot, in place."""
        hist[torch.arange(x.shape[0], device=x.device), wslot] = x
        return hist

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
        state = dict(x=zeros, alpha=zeros.clone())
        if statics.get("ASYNC"):
            state["hist"] = self._hist(aux, statics)
        return state

    def step(self, state, inp, aux, statics):
        x, alpha = state["x"], state["alpha"]
        A, deg, rho = aux["A"], aux["deg"], aux["rho"]
        if statics.get("ASYNC"):
            # Delayed-broadcast D-ADMM: dual-first from the PRE-update
            # iterate. The published age-1 value at delta = 0 IS x_k, so
            # alpha' accumulates exactly the synchronous dual residuals
            # and the degenerate async path reproduces the synchronous
            # sequence; crashed agents (act = 0) freeze primal and dual.
            wslot, rslot, act = inp
            nbr_sum = _mix(A, self._published(state["hist"], rslot))
            alpha_new = alpha + rho * (deg * x - nbr_sum)
            rhs = aux["rhs0"] + rho * (deg * x + nbr_sum) - alpha_new
            x_new = _solve(aux["Hs"], rhs)
            gate = _gate(act)
            x_new = torch.where(gate, x_new, x)
            alpha = torch.where(gate, alpha_new, alpha)
            hist = self._publish(state["hist"], wslot, x_new)
            state = dict(x=x_new, alpha=alpha, hist=hist)
        else:
            rhs = aux["rhs0"] + rho * (deg * x + _mix(A, x)) - alpha
            x_new = _solve(aux["Hs"], rhs)
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
        state = dict(x=torch.zeros(
            aux["shape"], dtype=aux["dtype"], device=aux["x_star"].device
        ))
        if statics.get("ASYNC"):
            state["hist"] = self._hist(aux, statics)
        return state

    def step(self, state, inp, aux, statics):
        x = state["x"]
        alpha = inp[0][:, None, None, None]
        if statics.get("ASYNC"):
            _, wslot, rslot, act = inp
            # Mix stale published neighbour iterates; the gradient is at
            # the agent's own fresh iterate.
            mixed = _mix(aux["W"], self._published(state["hist"], rslot))
            x_new = mixed - alpha * self._grad(aux, x)
            x_new = torch.where(_gate(act), x_new, x)
            hist = self._publish(state["hist"], wslot, x_new)
            state = dict(x=x_new, hist=hist)
        else:
            x_new = _mix(aux["W"], x) - alpha * self._grad(aux, x)
            state = dict(x=x_new)
        return state, self.metrics(x_new, x_new.mean(dim=1), aux)


class EXTRA(_GossipKernel):
    """EXTRA [7]: exact first-order gossip with constant step size."""

    name = "EXTRA"
    _ages = 2  # reads publications one AND two rounds back

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
        state = dict(x_prev=x0, x=x1)
        if statics.get("ASYNC"):
            # Slot D-1 holds x1 (the round-(-1) publication read at
            # delta = 0 in round 0); slot D-2 stays x0 = 0.
            hist = self._hist(aux, statics)
            hist[:, statics["D"] - 1] = x1
            state["hist"] = hist
        return state

    def step(self, state, inp, aux, statics):
        x_prev, x_cur = state["x_prev"], state["x"]
        if statics.get("ASYNC"):
            wslot, rslot_prev, rslot, act = inp
            mix_cur = self._published(state["hist"], rslot)
            mix_prev = self._published(state["hist"], rslot_prev)
        else:
            mix_cur, mix_prev = x_cur, x_prev
        x_next = (
            _mix(aux["I_plus_W"], mix_cur)
            - _mix(aux["W_tilde"], mix_prev)
            - aux["alpha"] * (self._grad(aux, x_cur) - self._grad(aux, x_prev))
        )
        if statics.get("ASYNC"):
            gate = _gate(act)
            x_next = torch.where(gate, x_next, x_cur)
            # A frozen agent's recursion pair freezes with it.
            new_prev = torch.where(gate, x_cur, x_prev)
            hist = self._publish(state["hist"], wslot, x_next)
            state = dict(x_prev=new_prev, x=x_next, hist=hist)
        else:
            state = dict(x_prev=x_cur, x=x_next)
        return state, self.metrics(x_next, x_next.mean(dim=1), aux)


D_ADMM_K = register(DADMM())
DGD_K = register(DGD())
EXTRA_K = register(EXTRA())
