"""a-csI-ADMM: online bandit control of the code/deadline frontier.

PyTorch port of `repro.control.kernel`. `AdaptiveADMM` runs the coded
incremental-ADMM family under a bandit controller: every iteration,
carry-resident UCB1/EXP3 state picks one arm per run from a registered
set of (code family, S, deadline) cells, the step executes that arm's
schedule row — its decode row reaches K1 through the base step — and the
arm's observed iteration wall-clock feeds back as reward, all inside the
driver's one step loop.

`prepare` builds EVERY arm's full per-iteration schedule (decode
weights, live-partition mask, sub-batch offset, activity) with
`repro_torch.core.admm.make_schedule`, stacks them on an arm axis, and
tabulates the (iters, n_arms) reward surface from the shared timing
draws — the same ECN/link samples back every arm (identical seed
stream), so the table says what THIS iteration would have cost under
THAT arm. The ``_select_arm`` hook then resolves the controller state
into a standard-layout pseudo-``inp``; the base step algebra, the K1
path, the async pend ring and the streaming reductions all compose
unchanged.

Because rewards are tabulated host-side, the controller's trajectory is
a deterministic function of host data: `prepare` replays the bandit
recursion in numpy (`repro_torch.control.bandit.replay`) to realize the
pull-dependent simulated clock and the async staleness/activity
schedules before the loop runs. All of the host side is numpy and bit
for bit the reference's.

A single-arm controller degenerates to the static csI-ADMM path: its
`prepare` defers to `IncrementalADMM` with the arm spliced into config
and timing, so statics, steps, and therefore the arithmetic are those of
the fixed-cell run. The static signature still gains the ``("adaptive",
n_arms, algo)`` suffix, so adaptive cases never merge into a group
another kernel would config-build.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.admm import make_schedule
from repro_torch.core.coding import check_arm_set, make_arm_set
from repro_torch.core.timing import TimingModel
from repro_torch.methods.admm import ADMMRun, IncrementalADMM
from repro_torch.methods.base import (
    Prepared,
    prepared_to_device,
    register,
    resolve_device,
)

from .bandit import (
    BanditPolicy,
    init_state,
    replay,
    schedule_inputs,
    select,
    update,
)

__all__ = ["AdaptiveRun", "AdaptiveADMM", "ADAPTIVE_KERNEL", "device_pulls"]

# Adaptive step-input layout: 0..5 are the base family's slots (with 1,
# 2, 5 arm-stacked), then the controller's host-side inputs. The async
# ring trio still appends LAST (read via negative indices).
_U, _LOGK, _REWARDS = 6, 7, 8
_N_ADAPTIVE_INPUTS = 9


@dataclasses.dataclass(frozen=True)
class AdaptiveRun(ADMMRun):
    """ADMM run config + the controller's arm set and bandit policy.

    ``cfg.scheme``/``cfg.S`` of the base config are placeholders; the
    live values come from ``arms`` — each a (scheme, S, deadline) cell
    of the code/deadline frontier. ``timing.deadline`` is likewise
    overridden per arm.
    """

    arms: Tuple[Tuple[str, int, Optional[float]], ...] = ()
    policy: BanditPolicy = BanditPolicy()


class AdaptiveADMM(IncrementalADMM):
    """Bandit-controlled csI-ADMM (one kernel, registered "a-csI-ADMM").

    Inherits the entire base family: the adaptive behavior lives in
    `prepare` (arm-stacked schedules + reward table + host replay) and
    the ``_select_arm`` hook (per-run arm pull + reward feedback).
    ``name`` stays "admm" so the single-arm degenerate case produces the
    static family's statics.
    """

    # -- host side ---------------------------------------------------------

    def config(self, case) -> AdaptiveRun:
        cfg = case.admm_config()
        if cfg.exact_x:
            raise ValueError(
                "adaptive control requires the stochastic coded x-update; "
                "exact_x (I-ADMM) has no code/deadline frontier to select on"
            )
        arms = tuple(
            (scheme, int(S), deadline)
            for scheme, S, deadline in case.arms
        )
        # Arm-set construction fails HERE — at grid construction, with
        # the uniform make_code infeasibility message — never in the loop.
        check_arm_set(arms, cfg.K)
        for scheme, S, _ in arms:
            dataclasses.replace(cfg, scheme=scheme, S=S).validate()
        return AdaptiveRun(
            cfg,
            case.timing_model(),
            arms=arms,
            policy=BanditPolicy(
                algo=case.bandit,
                c=case.bandit_c,
                eta=case.bandit_eta,
                gamma=case.bandit_gamma,
            ),
        )

    def static_signature(self, problem, run: AdaptiveRun, iters: int) -> tuple:
        # The suffix applies to the single-arm degenerate too: its
        # statics are the static family's, but it must never merge into a
        # group whose first case another kernel would config-build.
        return super().static_signature(problem, run, iters) + (
            "adaptive", len(run.arms), run.policy.algo,
        )

    def _degenerate(self, run: AdaptiveRun) -> ADMMRun:
        """The static run a single-arm controller is identical to."""
        scheme, S, deadline = run.arms[0]
        timing = run.timing or TimingModel()
        return ADMMRun(
            dataclasses.replace(run.cfg, scheme=scheme, S=S),
            dataclasses.replace(timing, deadline=deadline),
        )

    def _arm_tables(self, problem, net, run: AdaptiveRun, iters: int) -> dict:
        """Host-side arm-stacked schedules, reward table, and replay.

        All arms consume the SAME timing seed streams (`make_schedule`
        re-draws with the run seed per arm, and the draws depend only on
        (iters, K, seed)), so row k of every arm's schedule describes
        the same realized fleet under a different code/deadline choice.
        """
        cfg, timing = run.cfg, run.timing or TimingModel()
        codes = make_arm_set(run.arms, cfg.K, seed=cfg.seed)
        dt = problem.O.dtype
        comm = self._comm_per_iter(run, problem)
        scheds, W_a, mask_a, dt_a = [], [], [], []
        for (scheme, S, deadline), code in zip(run.arms, codes):
            acfg = dataclasses.replace(cfg, scheme=scheme, S=S)
            acfg.validate()
            sched = make_schedule(
                acfg, net, code,
                dataclasses.replace(timing, deadline=deadline),
                iters, problem.b,
            )
            scheds.append(sched)
            W_a.append((sched["decode"].astype(dt) @ code.B.astype(dt)) / cfg.K)
            cover = np.abs(code.B) > 1e-12
            mask_a.append(
                ((sched["alive"].astype(dt) @ cover.astype(dt)) > 0).astype(dt)
            )
            dt_a.append(sched["resp_time"] + sched["link_time"] * comm)
        dt_arm = np.stack(dt_a, axis=1)  # (iters, A) observed wall-clock
        rewards = timing.reward(dt_arm).astype(dt)
        u, logk = schedule_inputs(iters, cfg.seed)
        pulls = replay(run.policy, np.asarray(rewards, float), u, logk)
        return dict(
            scheds=scheds,
            W=np.stack(W_a, axis=1),  # (iters, A, K)
            wmask=np.stack(mask_a, axis=1),  # (iters, A, K)
            offsets=np.stack(
                [s["offsets"] for s in scheds], axis=1
            ).astype(np.int32),
            act=np.stack([s["act"] for s in scheds], axis=1),
            mu_arms=np.array([s["mu"] for s in scheds], dtype=np.int32),
            dt_arm=dt_arm,
            rewards=rewards,
            u=u,
            logk=logk,
            pulls=pulls,
            sim_time=np.cumsum(dt_arm[np.arange(iters), pulls]),
        )

    def prepare(self, problem, net, run: AdaptiveRun, iters: int):
        if len(run.arms) == 1:
            # Degenerate controller: EXACTLY the static path — same
            # consts, steps and statics.
            return super().prepare(problem, net, self._degenerate(run), iters)
        cfg, timing = run.cfg, run.timing or TimingModel()
        tab = self._arm_tables(problem, net, run, iters)
        dt = problem.O.dtype
        sched0 = tab["scheds"][0]
        # Slots 6..8 are the controller inputs, so the adaptive kernel
        # takes no `_extra_steps` subclass extras (privacy/compression
        # are separate registry entries).
        steps = (
            sched0["agents"],
            tab["offsets"],
            tab["W"],
            sched0["tau"].astype(dt),
            sched0["gamma"].astype(dt),
            tab["wmask"],
            tab["u"].astype(dt),
            tab["logk"].astype(dt),
            tab["rewards"],
        )
        statics = dict(
            self._statics(run, problem, iters, sched0),
            ADAPTIVE=True,
            A=len(run.arms),
            ALGO=run.policy.algo,
        )
        sim_time = tab["sim_time"]
        if timing.is_async:
            # The base async path's ring slots, but on the REALIZED
            # pull-dependent clock, and with the pulled arm's activity
            # gate (a churned pattern may be decodable under one arm and
            # not another).
            D = timing.staleness_cap
            delta = timing.staleness_steps(
                sim_time, np.random.default_rng([7, cfg.seed])
            )
            k = np.arange(iters)
            act = tab["act"][k, tab["pulls"]]
            steps = steps + (
                ((k + delta) % D).astype(np.int32),
                (k % D).astype(np.int32),
                act.astype(dt),
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
                np.asarray(int(tab["mu_arms"].max()), dtype=np.int32),
                tab["mu_arms"],
                run.policy.params.astype(dt),
            ),
            steps=steps,
            statics=statics,
            max_statics=dict(MU=int(tab["mu_arms"].max())),
            comm=np.cumsum(np.full(iters, self._comm_per_iter(run, problem))),
            sim_time=sim_time,
        )

    def max_statics_bound(self, problem, run: AdaptiveRun, iters: int) -> dict:
        if len(run.arms) == 1:
            return super().max_statics_bound(
                problem, self._degenerate(run), iters
            )
        return dict(
            MU=max(
                dataclasses.replace(run.cfg, scheme=scheme, S=S).M_bar
                // run.cfg.K
                for scheme, S, _ in run.arms
            )
        )

    # -- device side -------------------------------------------------------

    def setup(self, consts, statics):
        aux = super().setup(consts[:7], statics)
        if statics.get("ADAPTIVE"):
            aux = dict(aux, mu_arms=consts[7], bpar=consts[8])
        return aux

    def init(self, aux, statics):
        state = super().init(aux, statics)
        if statics.get("ADAPTIVE"):
            R = aux["shape"][0]
            state = dict(state, bandit=init_state(
                R, statics["A"], aux["dtype"], aux["x_star"].device
            ))
        return state

    def _select_arm(self, state, inp, aux, statics):
        if not statics.get("ADAPTIVE"):
            return state, inp, aux
        algo, n_arms, runs = statics["ALGO"], statics["A"], aux["runs"]
        arm = select(
            algo, state["bandit"], inp[_U], inp[_LOGK], aux["bpar"], n_arms
        )
        state = dict(
            state,
            bandit=update(
                algo, state["bandit"], arm, inp[_REWARDS][runs, arm],
                aux["bpar"], n_arms,
            ),
        )
        # The pulled arm's sub-batch size mu: re-derive the masked 1/mu
        # row weights the base setup fixed from the runs' scalar bound.
        mu_k = aux["mu_arms"][runs, arm]
        valid = (aux["rows"][None, :] < mu_k[:, None]).to(aux["dtype"])
        inv_mu = 1.0 / mu_k.to(aux["dtype"])
        aux = dict(aux, row_w=(valid * inv_mu[:, None])[:, None, :, None])
        # Standard-layout pseudo-inp: the live arm's schedule row in
        # slots 0..5, controller slots dropped, async trio (if any)
        # preserved at the end.
        sel = (
            inp[0], inp[1][runs, arm], inp[2][runs, arm], inp[3], inp[4],
            inp[5][runs, arm],
        )
        return state, sel + tuple(inp[_N_ADAPTIVE_INPUTS:]), aux


ADAPTIVE_KERNEL = register(AdaptiveADMM(), "a-csI-ADMM")


def device_pulls(
    problem, net, run: AdaptiveRun, iters: int, *, device="cuda",
    dtype: torch.dtype = torch.float64,
) -> np.ndarray:
    """The DEVICE controller's realized pull sequence (test/diagnostic).

    Runs the driver's step loop for this one run and records each
    iteration's arm, recomputed from the pre-update carry exactly as
    ``_select_arm`` does. It equals the host `replay` (which computes in
    float64, hence the default ``dtype``). Returns (iters,) int32.
    """
    if len(run.arms) < 2:
        raise ValueError("device_pulls needs a multi-arm adaptive run")
    kernel = ADAPTIVE_KERNEL
    prep = kernel.prepare(problem, net, run, iters)
    statics = dict(prep.statics, **prep.max_statics)
    consts, steps = prepared_to_device(
        tuple(np.asarray(c)[None] for c in prep.consts),
        tuple(np.asarray(s)[None] for s in prep.steps),
        device=resolve_device(device), dtype=dtype,
    )
    arms = []
    with torch.inference_mode():
        aux = kernel.setup(consts, statics)
        state = kernel.init(aux, statics)
        for k in range(iters):
            inp = tuple(s[:, k] for s in steps)
            arms.append(select(
                statics["ALGO"], state["bandit"], inp[_U], inp[_LOGK],
                aux["bpar"], statics["A"],
            ))
            state, _ = kernel.step(state, inp, aux, statics)
        pulls = torch.stack(arms, dim=1)[0]
    return pulls.cpu().numpy().astype(np.int32)
