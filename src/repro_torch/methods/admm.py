"""Incremental (c)sI-/I-ADMM as a MethodKernel (paper Algorithms 1 & 2).

PyTorch port of `repro.methods.admm`: the ONE step of the whole ADMM family,
written once over a leading runs axis R. Per step (active agent
i = i_k of each run, eqs. 5a/5b/4c):

  x_i^{k+1} = (tau^k x_i^k + rho z^k + y_i^k - G_i) / (rho + tau^k)
  y_i^{k+1} = y_i^k + rho gamma^k (z^k - x_i^{k+1})
  z^{k+1}   = z^k + [ (x_i^{k+1}-x_i^k) - (y_i^{k+1}-y_i^k)/rho ] / N

with G_i the decoded mini-batch gradient (eq. 6). The coded
encode->decode path collapses host-side to per-partition weights
w = (a^T B)/K; the device step computes one masked sub-batch gradient
message per ECN partition (gather + einsum) and hands decode-combine +
eq. (5a) to `repro_torch.kernels.ops.coded_admm_update` — the CUDA kernel
on a card, its plain version on the CPU. The sub-batch size
mu = M/((S+1)K) is a per-run input masked against the batch bound MU, so
a whole straggler-tolerance sweep shares one batch. I-ADMM (exact_x)
replaces the stochastic x-update with the closed-form full-batch solve
(eq. 4a, `torch.linalg.solve_ex`).

Event-driven mode: when the run's `TimingModel` is async (``tau_max > 0``
or ``churn_rate > 0``) the token increment dz of iteration k lands with a
bounded simulated delay instead of at once. The carry holds a ``pend``
ring of ``staleness_cap`` in-flight increments per run, (R, D, p, d);
host-computed write/read slots and the activity gate are THREE step
inputs appended after every subclass extra (read by negative index, so
the hooks' positional inputs keep their places). A skipped activation
(crashed agent, undecodable churned pattern — `make_schedule`) gates x, y
and dz to exact zeros. Sync runs keep the exact pre-async signature,
statics and steps, hence the same arithmetic.

The hooks ``_select_arm`` (a-csI-ADMM, `repro_torch.control.kernel`),
``_perturb_x`` (pI-ADMM), ``_token_increment`` (cq-sI-ADMM) and
``_token_update`` (the async ring) let the variants subclass without
touching the step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.admm import ADMMConfig, make_schedule
from repro_torch.core.coding import GradientCode, make_code
from repro_torch.core.graph import Network
from repro_torch.core.problems import LeastSquaresProblem
from repro_torch.core.timing import TimingModel
from repro_torch.kernels.ops import coded_admm_update

from .base import MethodKernel, Prepared, register

__all__ = ["ADMMRun", "IncrementalADMM", "ADMM_KERNEL"]


@dataclasses.dataclass(frozen=True)
class ADMMRun:
    """Per-run config of the ADMM family: hyper-params + timing model."""

    cfg: ADMMConfig
    timing: Optional[TimingModel] = None
    code: Optional[GradientCode] = None


class IncrementalADMM(MethodKernel):
    """sI-ADMM / csI-ADMM / I-ADMM (ONE kernel, three registry names).

    The behavioral switches (exact_x, scheme, S) all live in the
    `ADMMConfig`, so a single instance serves all three paper names and
    mixed sI/csI grids with equal shapes share a static signature and
    batch together."""

    name = "admm"

    # -- host side ---------------------------------------------------------

    def config(self, case) -> ADMMRun:
        return ADMMRun(case.admm_config(), case.timing_model())

    def static_signature(
        self, problem: LeastSquaresProblem, run: ADMMRun, iters: int
    ) -> tuple:
        cfg = run.cfg
        sig = (
            self.name,
            problem.N, problem.b, problem.p, problem.d,
            problem.O_test.shape[0],
            cfg.K, problem.b // cfg.K, cfg.exact_x, iters,
        )
        if run.timing is not None and run.timing.is_async:
            # Async runs carry the pend ring and three more step inputs:
            # a group of their own per ring depth.
            sig += ("async", run.timing.staleness_cap)
        return sig

    def prepare(
        self,
        problem: LeastSquaresProblem,
        net: Network,
        run: ADMMRun,
        iters: int,
    ) -> Prepared:
        cfg = run.cfg
        cfg.validate()
        timing = run.timing or TimingModel()
        code = run.code or make_code(cfg.scheme, cfg.K, cfg.S, seed=cfg.seed)
        if code.K != cfg.K or code.S != cfg.S:
            raise ValueError("code does not match config (K, S)")

        sched = make_schedule(cfg, net, code, timing, iters, problem.b)
        dt = problem.O.dtype
        # Encode->decode folds to per-partition weights host-side: the
        # decoded mini-batch gradient (eq. 6) is
        #   G = (1/K) sum_j a_j sum_t B[j,t] g~_t = sum_t w_t g~_t.
        W_steps = (sched["decode"].astype(dt) @ code.B.astype(dt)) / cfg.K
        # Runtime live-partition mask for the fused kernel: partition t is
        # live iff some alive ECN covers it.
        cover = np.abs(code.B) > 1e-12  # (K ecn, K partition)
        wmask = (sched["alive"].astype(dt) @ cover.astype(dt)) > 0
        # One token hop per activation; response + link time per iter.
        sim_time = np.cumsum(
            sched["resp_time"]
            + sched["link_time"] * self._comm_per_iter(run, problem)
        )
        steps = self._extra_steps(
            run, problem, iters,
            (
                sched["agents"],
                sched["offsets"],
                W_steps,
                sched["tau"].astype(dt),
                sched["gamma"].astype(dt),
                wmask.astype(dt),
            ),
        )
        statics = self._statics(run, problem, iters, sched)
        if timing.is_async:
            # Write/read ring slots + activity gate, after subclass extras.
            # Staleness is sampled on the run's own clock (stream [7,
            # seed]); a delay of d in [0, D-1] steps lands the increment
            # written at iteration k at the end of iteration k + d (d = 0
            # is the synchronous landing).
            D = timing.staleness_cap
            delta = timing.staleness_steps(
                sim_time, np.random.default_rng([7, cfg.seed])
            )
            k = np.arange(iters)
            steps = steps + (
                ((k + delta) % D).astype(np.int32),
                (k % D).astype(np.int32),
                sched["act"].astype(dt),
            )
            statics = dict(statics, ASYNC=True, D=D)
        return Prepared(
            consts=(
                problem.O,
                problem.T,
                problem.x_star().astype(dt),
                problem.O_test,
                problem.T_test,
                np.asarray(cfg.rho, dtype=dt),
                np.asarray(sched["mu"], dtype=np.int32),
            ),
            steps=steps,
            statics=statics,
            max_statics=dict(MU=int(sched["mu"])),
            comm=np.cumsum(np.full(iters, self._comm_per_iter(run, problem))),
            sim_time=sim_time,
        )

    def max_statics_bound(
        self, problem: LeastSquaresProblem, run: ADMMRun, iters: int
    ) -> dict:
        # Exact: make_schedule's mu IS M_bar // K (no sampling involved).
        return dict(MU=run.cfg.M_bar // run.cfg.K)

    def _statics(self, run: ADMMRun, problem, iters, sched) -> dict:
        return dict(
            name=self.name, iters=iters, P=sched["P"], K=run.cfg.K,
            N=problem.N, exact_x=run.cfg.exact_x,
        )

    def _extra_steps(self, run: ADMMRun, problem, iters, steps: tuple) -> tuple:
        """Hook: subclasses append host-sampled per-step arrays (noise)."""
        return steps

    def _comm_per_iter(self, run: ADMMRun, problem) -> float:
        return 1.0

    # -- device side -------------------------------------------------------

    def setup(self, consts, statics):
        O, T, x_star, O_test, T_test, rho, mu = consts
        R, N, b, p = O.shape
        d = T.shape[3]
        dev = O.device
        rows = torch.arange(statics["MU"], device=dev)
        # Sub-batch rows >= a run's own mu carry weight exactly 0, which is
        # what lets runs of different mu (mixed S) share one batch bound MU.
        valid = (rows[None, :] < mu[:, None]).to(O.dtype)
        inv_mu = 1.0 / mu.to(O.dtype)
        part = torch.arange(statics["K"], device=dev)
        O_test_t = O_test.transpose(1, 2)
        aux = dict(
            x_star=x_star,
            xs_norm=torch.linalg.vector_norm(x_star.reshape(R, -1), dim=1),
            # test error via the test set's Gram/cross matrices: p x p per
            # step instead of n_test x p.
            Gt=O_test_t @ O_test,
            Ct=O_test_t @ T_test,
            TTt=(T_test * T_test).sum(dim=(1, 2)),
            n_test=O_test.shape[1],
            # Flat views: per-step mini-batches gather the K*MU needed rows
            # straight out of each run's (N*b, p) pool.
            O_flat=O.reshape(R, N * b, p),
            T_flat=T.reshape(R, N * b, d),
            last_row=N * b - 1,
            runs=torch.arange(R, device=dev),
            rows=rows,
            # (K, MU) row offsets of every partition's sub-batch in an
            # agent's block, and the (R, 1, MU, 1) masked 1/mu weights.
            base=part[:, None] * statics["P"] + rows[None, :],
            row_w=(valid * inv_mu[:, None])[:, None, :, None],
            rho=rho,
            b=b,
            shape=(R, N, p, d),
            dtype=O.dtype,
        )
        if statics["exact_x"]:
            # I-ADMM exact solve operands: (O^T O / b + rho I), O^T T / b.
            aux["H"] = torch.einsum("rnbp,rnbq->rnpq", O, O) / b
            aux["rhs0"] = torch.einsum("rnbp,rnbd->rnpd", O, T) / b
            aux["eye"] = torch.eye(p, dtype=O.dtype, device=dev)
        return aux

    def init(self, aux, statics):
        state = self.xyz_state(aux)
        if statics.get("ASYNC"):
            # Ring of in-flight token increments: slot s of a run holds
            # the sum of increments landing at the end of its next
            # iteration k with k % D == s.
            R, N, p, d = aux["shape"]
            state["pend"] = torch.zeros(
                (R, statics["D"], p, d), dtype=aux["dtype"],
                device=aux["x_star"].device,
            )
        return state

    def step(self, state, inp, aux, statics):
        """One iteration of every run. Writes the active agents' rows of
        x and y in place."""
        state, inp, aux = self._select_arm(state, inp, aux, statics)
        i, off, w, tk, gk = inp[0], inp[1], inp[2], inp[3], inp[4]
        x, y, z = state["x"], state["y"], state["z"]
        runs = aux["runs"]
        xi, yi = x[runs, i], y[runs, i]  # (R, p, d) copies
        rho = aux["rho"]
        rho3 = rho[:, None, None]
        N, K = statics["N"], statics["K"]
        R = xi.shape[0]

        if statics["exact_x"]:
            # solve_ex: `solve` without its singularity check, which
            # waits for the card every step; H + rho I is positive
            # definite, and the result is the same bits.
            x_new = torch.linalg.solve_ex(
                aux["H"][runs, i] + rho3 * aux["eye"],
                aux["rhs0"][runs, i] + rho3 * z + yi,
            ).result
        else:
            # One gather of all K partitions' sub-batches. With mixed mu in
            # a batch, rows >= a run's mu can index past its N*b pool (the
            # reference relies on JAX clamping such gathers); clamp them
            # explicitly — they carry weight exactly 0 through row_w.
            idx = ((i * aux["b"] + off)[:, None, None] + aux["base"]).clamp_max(
                aux["last_row"]
            )
            rr = runs[:, None, None]
            Ob = aux["O_flat"][rr, idx]  # (R, K, MU, p)
            Tb = aux["T_flat"][rr, idx]  # (R, K, MU, d)
            # Per-ECN coded message: the masked sub-batch gradient g~_j
            # (eq. 6 before decode), one row of the fused kernel's msgs.
            r = aux["row_w"] * (Ob @ xi[:, None] - Tb)
            msgs = torch.einsum("rkmp,rkmd->rkpd", Ob, r).reshape(R, K, -1)
            # Fused decode-combine + eq. (5a); w already folds a^T B / K,
            # and inp[5] is the live-partition mask of this iteration.
            x_new = coded_admm_update(
                msgs, w, xi.reshape(R, -1), yi.reshape(R, -1),
                z.reshape(R, -1), tk, rho, inp[5],
            ).reshape(xi.shape)

        x_new = self._perturb_x(x_new, inp, aux, statics)
        if statics.get("ASYNC"):
            # Skipped activation (crashed agent / undecodable pattern):
            # act = 0 freezes x and y, making dz an exact zero below.
            # where-gating (not act-scaling) keeps the act = 1 path
            # bitwise that of the ungated computation.
            live = inp[-1][:, None, None] > 0
            x_new = torch.where(live, x_new, xi)
        y_new = yi + rho3 * gk[:, None, None] * (z - x_new)  # eq. (5b)
        if statics.get("ASYNC"):
            y_new = torch.where(live, y_new, yi)
        dz = ((x_new - xi) - (y_new - yi) / rho3) / N  # eq. (4c) increment
        x[runs, i] = x_new
        y[runs, i] = y_new
        state = self._token_update(dict(state, x=x, y=y), dz, inp, aux, statics)
        return state, self.metrics(state["x"], state["z"], aux)

    def _select_arm(self, state, inp, aux, statics):
        """Hook: the online controller resolves arm-stacked step inputs.

        Runs before anything else in :meth:`step`; identity for the
        non-adaptive family, so the static paths keep their exact
        arithmetic. `repro_torch.control.kernel` overrides it to pull a
        bandit arm per run from carry state, feed back its reward, and
        return a standard-layout pseudo-``inp`` of the pulled arm's
        schedule row."""
        return state, inp, aux

    def _perturb_x(self, x_new, inp, aux, statics):
        """Hook: pI-ADMM adds Gaussian noise to the shared primal."""
        return x_new

    def _token_increment(self, state, dz, inp, aux, statics):
        """Hook: compute the transmitted token increment.

        Returns ``(state_updates, c)`` where ``c`` is the increment the
        active agent actually ships (cq-sI-ADMM compresses dz here) and
        ``state_updates`` are carry entries the hook mutates.
        """
        return {}, dz

    def _token_update(self, state, dz, inp, aux, statics):
        """Apply the token increment: directly (sync) or through the pend
        ring with bounded staleness (async)."""
        upd, c = self._token_increment(state, dz, inp, aux, statics)
        if not statics.get("ASYNC"):
            return dict(state, **upd, z=state["z"] + c)
        wslot, rslot = inp[-3], inp[-2]
        live = inp[-1][:, None, None] > 0
        # Dead activations transmit nothing and leave hook state alone.
        upd = {k: torch.where(live, v, state[k]) for k, v in upd.items()}
        pend, runs = state["pend"], aux["runs"]
        # Each run adds at its own write slot, in place (the ring is the
        # loop's own carry).
        pend[runs, wslot] = pend[runs, wslot] + torch.where(
            live, c, torch.zeros_like(c)
        )
        # Land every increment maturing at this iteration's boundary (the
        # read slot includes this step's own write when delta = 0 — the
        # synchronous landing), then clear the slot.
        z = state["z"] + pend[runs, rslot]
        # A zero on the device: a Python 0.0 here is a host scalar that
        # the indexed write copies over, which waits for the card.
        pend[runs, rslot] = pend.new_zeros(())
        return dict(state, **upd, z=z, pend=pend)

    def final(self, state, aux, statics):
        z = state["z"]
        if statics.get("ASYNC"):
            # Flush in-flight increments: the run ends, updates land.
            z = z + state["pend"].sum(dim=1)
        return state["x"], z


ADMM_KERNEL = register(IncrementalADMM(), "sI-ADMM", "csI-ADMM", "I-ADMM")
