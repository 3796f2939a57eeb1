"""W-ADMM (Walkman [3]) as a MethodKernel — random-walk incremental ADMM.

PyTorch port of `repro.methods.walkman`. Same incremental
proximal-linearized updates as sI-ADMM, but the token performs a uniform
random walk over neighbors (one agent + one link per iteration) and the
stochastic gradient is a plain contiguous mini-batch (no ECN
partitioning / coding, so no fused kernel: the x-update is plain, as in
the reference).

The walk, the mini-batch offsets and the clock are host-side numpy, bit
for bit the reference's: the walk from ``default_rng(cfg.seed)``, the
clock from `TimingModel.walk_step_times` on stream [5, seed]. The device
step runs over a leading runs axis R; the reference's per-run
``dynamic_slice`` of the active agent's block becomes one gather of each
run's M rows from its flat (N*b, p) pool.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Network
from repro_torch.core.problems import LeastSquaresProblem
from repro_torch.core.timing import TimingModel

from .admm import ADMMRun
from .base import MethodKernel, Prepared, register

__all__ = ["WalkmanADMM", "W_ADMM"]


class WalkmanADMM(MethodKernel):
    name = "W-ADMM"

    def config(self, case) -> ADMMRun:
        return ADMMRun(case.admm_config(), case.timing_model())

    def static_signature(
        self, problem: LeastSquaresProblem, run: ADMMRun, iters: int
    ) -> tuple:
        return (
            self.name, run.cfg.M,
            problem.N, problem.b, problem.p, problem.d,
            problem.O_test.shape[0], iters,
        )

    def prepare(
        self,
        problem: LeastSquaresProblem,
        net: Network,
        run: ADMMRun,
        iters: int,
    ) -> Prepared:
        cfg = run.cfg
        timing = run.timing or TimingModel()
        if timing.is_async:
            # The walk's single token has no in-flight redundancy to
            # delay and no fleet to churn — a crashed holder would simply
            # end the run. Keep the failure loud rather than silently
            # running synchronously (the reference's DESIGN.md §13).
            raise NotImplementedError(
                "W-ADMM has no event-driven mode (tau_max/churn_rate must "
                "be 0); see DESIGN.md §13"
            )
        N, b = problem.N, problem.b
        rng = np.random.default_rng(cfg.seed)
        agents = np.zeros(iters, dtype=np.int32)
        cur = int(rng.integers(N))
        for k in range(iters):
            agents[k] = cur
            cur = int(rng.choice(net.neighbors(cur)))
        nb = max(b // cfg.M, 1)
        offsets = ((np.arange(iters) // N % nb) * cfg.M).astype(np.int32)
        tau = cfg.c_tau * np.sqrt(np.arange(1, iters + 1))
        gamma = cfg.c_gamma / np.sqrt(np.arange(1, iters + 1))
        dt = problem.O.dtype
        return Prepared(
            consts=(
                problem.O,
                problem.T,
                problem.x_star().astype(dt),
                problem.O_test,
                problem.T_test,
                np.asarray(cfg.rho, dtype=dt),
            ),
            steps=(agents, offsets, tau.astype(dt), gamma.astype(dt)),
            statics=dict(name=self.name, iters=iters, M=cfg.M, N=N),
            max_statics={},
            comm=np.cumsum(np.ones(iters)),  # one link per walk step
            sim_time=np.cumsum(
                timing.walk_step_times(
                    net, agents, np.random.default_rng([5, cfg.seed])
                )
            ),
        )

    def setup(self, consts, statics):
        O, T, x_star, O_test, T_test, rho = consts
        aux = self.lsq_aux(O, T, x_star, O_test, T_test)
        R, N, b, p = O.shape
        aux.update(
            rho=rho,
            O_flat=O.reshape(R, N * b, p),
            T_flat=T.reshape(R, N * b, T.shape[3]),
            rows=torch.arange(statics["M"], device=O.device),
            runs=torch.arange(R, device=O.device),
        )
        return aux

    def init(self, aux, statics):
        return self.xyz_state(aux)

    def step(self, state, inp, aux, statics):
        """One walk step of every run. Writes the active agents' rows of
        x and y in place."""
        i, off, tk, gk = inp
        x, y, z = state["x"], state["y"], state["z"]
        runs = aux["runs"]
        rho3 = aux["rho"][:, None, None]
        tk3, gk3 = tk[:, None, None], gk[:, None, None]
        M, N = statics["M"], statics["N"]
        # The active agent's contiguous mini-batch rows [off, off + M).
        idx = (i * aux["b"] + off)[:, None] + aux["rows"]
        Ob = aux["O_flat"][runs[:, None], idx]  # (R, M, p)
        Tb = aux["T_flat"][runs[:, None], idx]  # (R, M, d)
        xi, yi = x[runs, i], y[runs, i]  # (R, p, d) copies
        G = Ob.transpose(1, 2) @ (Ob @ xi - Tb) / M
        x_new = (tk3 * xi + rho3 * z + yi - G) / (rho3 + tk3)
        y_new = yi + rho3 * gk3 * (z - x_new)
        z_new = z + ((x_new - xi) - (y_new - yi) / rho3) / N
        x[runs, i] = x_new
        y[runs, i] = y_new
        state = dict(x=x, y=y, z=z_new)
        return state, self.metrics(x, z_new, aux)

    def final(self, state, aux, statics):
        return state["x"], state["z"]


W_ADMM = register(WalkmanADMM())
