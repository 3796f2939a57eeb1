"""Unified simulated wall-clock timing model — every method kernel's clock.

The paper's headline comparisons (Figs. 3(e), 4; §V-A) are on *running
time*: communication time among agents (per-link uniform U(comm_lo,
comm_hi) seconds) plus per-iteration compute/response time. One
`TimingModel` instance is consumed by every `MethodKernel.prepare`
(DESIGN.md §10), so the accuracy-vs-time axis is comparable across the
whole registry:

- **ADMM family** (sI-/csI-/I-/pI-/cq-sI-ADMM): per-activation time =
  ECN response (R-th fastest for coded, epsilon-capped slowest for
  uncoded — with the true wait recorded when *no* ECN beats the cap)
  plus one token-hop link time, scaled by the token's true bit cost for
  compressed variants (`repro_torch.core.admm.make_schedule`).
- **Gossip** (D-ADMM/DGD/EXTRA): per-round time = slowest-agent compute
  plus the slowest agent's serialized per-neighbor link transfers
  (:meth:`TimingModel.gossip_round_times`).
- **W-ADMM**: per-walk-step time = active-agent compute plus one link
  hop (:meth:`TimingModel.walk_step_times`).

Heterogeneous-fleet knobs: ``speed_classes`` assigns per-worker speed
factors round-robin (worker w runs ``speed_classes[w % len]`` times
slower than the homogeneous base), and ``response`` switches the base
compute draw between the paper's uniform model and the shifted
exponential of the coded-computing literature (response-time-aware edge
models, arXiv 2107.00481). Straggler events stay an *additive*
exponential delay on top — transient network/queueing stalls, not a
property of the machine class, so they are deliberately not scaled.

Event-driven mode (DESIGN.md §13): ``tau_max``/``churn_rate`` switch the
model from bulk-synchronous rounds to bounded-staleness updates and
elastic fleets — the dynamic-network settings surveyed in arXiv
1503.08855 and the edge-IIoT regime of arXiv 2107.00481. Both are
*pre-sampled schedules*: :meth:`staleness_steps` maps per-update
simulated delays tau ~ U(0, tau_max] onto integer step delays against a
run's cumulative clock, and :meth:`sample_churn` realizes a
crash/recover alternating-renewal process per worker on the same clock.
Kernels thread the resulting arrays through their scan as runtime data
(the PR-5 mask pattern), so asynchrony never retraces. ``tau_max = 0``
and ``churn_rate = 0`` (the defaults) keep every method on the exact
bulk-synchronous code path, bit for bit.

All times are *simulated* (the container has no cluster — the paper
itself simulates delays on a laptop), and every draw happens HOST-side
in ``prepare`` so device steps stay pure (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["TimingModel", "StragglerModel", "sample_times"]

_RESPONSES = ("uniform", "shifted_exp", "lognormal", "pareto")


@dataclasses.dataclass(frozen=True)
class TimingModel:
    """Per-worker compute/response-time distribution with planted stragglers.

    Every worker (ECN or agent) draws a base compute time — uniform
    U(base_lo, base_hi), or base_lo + Exp(mean=base_hi - base_lo) when
    ``response="shifted_exp"`` — multiplied by its speed-class factor.
    The heavy-tailed fleet models share the same floor and *mean excess*
    (base_hi - base_lo), so curves across response models compare at
    equal average compute: ``"lognormal"`` draws the excess from a
    mean-1 log-normal (sigma=1, mu=-1/2 — moderate tail, finite
    variance) and ``"pareto"`` from a mean-1 Lomax (shape a=2 — the
    edge-fleet regime with INFINITE variance, where a handful of workers
    dominate every round and coding must pay off).
    In each iteration, each worker independently straggles with
    probability ``p_straggle``; stragglers add a delay ~ Exp(mean=delay).
    ``epsilon`` caps how long an uncoded agent will wait for its ECNs
    (the paper's maximum delay parameter); it does not apply to workers
    nobody can drop (gossip rounds, walk steps, the no-response
    fallback).

    ``tau_max`` bounds the simulated delay of an *update landing*: each
    transmitted update is delayed by tau ~ U(0, tau_max] seconds and
    applied at the last iteration boundary within that window, so the
    realized staleness never exceeds ``tau_max`` (DESIGN.md §13).
    ``churn_rate`` is each worker's crash intensity (expected crashes
    per simulated second while up); ``mttr`` the mean time-to-recovery
    (0 = crashed workers never rejoin). ``staleness_cap`` bounds the
    ring-buffer depth of in-flight updates a kernel carries — delays are
    additionally clipped to ``staleness_cap - 1`` steps, which only ever
    *shortens* a delay, so the tau_max bound survives the clip.

    ``deadline`` is the per-iteration *decode deadline* (DESIGN.md §11):
    when set and the gradient code supports partial recovery
    (``code.min_responses < code.R``), a coded agent decodes at the
    deadline from whatever >= r_min responses have arrived — with the
    code's certified bounded error — instead of waiting for the R-th
    ECN; exact decode still wins whenever the R-th response beats the
    deadline, and a deadline that catches < r_min responses falls back
    to the exact wait. Exact-only code families ignore it entirely.
    """

    base_lo: float = 1e-4
    base_hi: float = 2e-4
    p_straggle: float = 0.1
    delay: float = 5e-3
    epsilon: float = 1e-2
    comm_lo: float = 1e-5  # per-link agent<->agent token time (paper §V-A)
    comm_hi: float = 1e-4
    # Heterogeneous fleet: worker w is speed_classes[w % len] x slower.
    speed_classes: Tuple[float, ...] = (1.0,)
    response: str = "uniform"  # one of _RESPONSES
    # Decode deadline for partial-recovery codes (None = wait for R).
    deadline: Optional[float] = None
    # Event-driven mode (DESIGN.md §13): staleness bound, churn process.
    tau_max: float = 0.0  # max simulated update delay; 0 = synchronous
    churn_rate: float = 0.0  # crashes per sim-second per worker; 0 = none
    mttr: float = 0.0  # mean time-to-recovery; 0 = crashes are permanent
    staleness_cap: int = 8  # ring-buffer depth D; step delays < D

    def __post_init__(self) -> None:
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(
                f"deadline must be positive or None, got {self.deadline}"
            )
        if self.tau_max < 0 or self.churn_rate < 0 or self.mttr < 0:
            raise ValueError(
                "tau_max, churn_rate, mttr must be >= 0, got "
                f"({self.tau_max}, {self.churn_rate}, {self.mttr})"
            )
        if self.staleness_cap < 2:
            raise ValueError(
                f"staleness_cap must be >= 2, got {self.staleness_cap}"
            )
        if self.response not in _RESPONSES:
            raise ValueError(
                f"unknown response model {self.response!r}; "
                f"known: {_RESPONSES}"
            )
        if not self.speed_classes or any(
            s <= 0 for s in self.speed_classes
        ):
            raise ValueError(
                f"speed_classes must be positive, got {self.speed_classes}"
            )

    @property
    def is_async(self) -> bool:
        """True when the event-driven mode is on (DESIGN.md §13): any
        staleness bound or churn process switches a kernel onto its
        ring-buffered async path and its own static signature."""
        return self.tau_max > 0 or self.churn_rate > 0

    # -- worker-level draws ------------------------------------------------

    def speed_factors(self, n: int) -> np.ndarray:
        """(n,) per-worker slowdown factors, classes assigned round-robin."""
        return np.resize(np.asarray(self.speed_classes, dtype=float), n)

    def sample_ecn_times(
        self, iters: int, K: int, rng: np.random.Generator
    ) -> np.ndarray:
        """(iters, K) per-worker times (uncapped; caller applies epsilon).

        Also the per-agent compute model of the gossip/walk baselines —
        one worker is one unit of local computation, whoever runs it.
        Draw order (base, straggle mask, delay) is part of the seed
        contract: homogeneous-uniform draws are bit-identical to the
        original `StragglerModel`.
        """
        scale = self.base_hi - self.base_lo
        if self.response == "uniform":
            base = rng.uniform(self.base_lo, self.base_hi, size=(iters, K))
        elif self.response == "shifted_exp":
            # Same support floor, exponential tail.
            base = self.base_lo + rng.exponential(scale, size=(iters, K))
        elif self.response == "lognormal":
            # Mean-1 log-normal excess (mu = -sigma^2/2, sigma = 1), so
            # E[base] matches shifted_exp at every scale.
            base = self.base_lo + scale * rng.lognormal(
                mean=-0.5, sigma=1.0, size=(iters, K)
            )
        else:  # pareto: mean-1 Lomax (shape 2), infinite variance
            base = self.base_lo + scale * rng.pareto(2.0, size=(iters, K))
        straggle = rng.random((iters, K)) < self.p_straggle
        extra = rng.exponential(self.delay, size=(iters, K))
        return base * self.speed_factors(K)[None, :] + straggle * extra

    def sample_link_times(
        self, iters, rng: np.random.Generator
    ) -> np.ndarray:
        """Per-hop token communication times; ``iters`` may be a shape."""
        return rng.uniform(self.comm_lo, self.comm_hi, size=iters)

    # -- per-kernel composite clocks (DESIGN.md §10) -----------------------

    def gossip_components(
        self, net, iters: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(comp (iters, N), per_agent_link (iters, N)) round ingredients.

        Split out of :meth:`gossip_round_times` so the async path can
        draw ONCE and then evaluate the round under different alive
        masks (the churn grid is built on the churn-free clock,
        DESIGN.md §13) without perturbing the seed contract.
        """
        comp = self.sample_ecn_times(iters, net.N, rng)
        link = self.sample_link_times((iters, net.E), rng)
        inc = np.zeros((net.E, net.N))
        for e, (i, j) in enumerate(net.edges):
            inc[e, i] = inc[e, j] = 1.0
        return comp, link @ inc

    def gossip_round_times(
        self, net, iters: int, rng: np.random.Generator, alive=None
    ) -> np.ndarray:
        """(iters,) round times for all-agents-per-step gossip methods.

        A round completes when the slowest agent has (a) computed its
        local update and (b) pushed one message to each neighbor; an
        agent's sends serialize over its uplink while distinct agents
        transmit concurrently, so the link term is the *max over agents*
        of the sum of their incident per-edge times. With an ``alive``
        (iters, N) mask, crashed agents neither compute nor transmit —
        the round completes when the slowest *alive* agent does, floored
        at ``base_lo`` so the clock stays strictly increasing even
        through an all-crashed round (DESIGN.md §13).
        """
        comp, per_agent = self.gossip_components(net, iters, rng)
        return self.gossip_round_from(comp, per_agent, alive)

    def gossip_round_from(
        self, comp: np.ndarray, per_agent: np.ndarray, alive=None
    ) -> np.ndarray:
        """Round times from pre-drawn :meth:`gossip_components`."""
        if alive is None:
            return comp.max(axis=1) + per_agent.max(axis=1)
        up = np.asarray(alive, dtype=bool)
        rt = np.where(up, comp, 0.0).max(axis=1) + np.where(
            up, per_agent, 0.0
        ).max(axis=1)
        return np.maximum(rt, self.base_lo)

    def walk_step_times(
        self, net, agents: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        """(iters,) W-ADMM step times: active-agent compute + one hop.

        The walk has no redundancy, so a straggling active agent blocks
        the token for its full delay — the honest exposure the coded
        methods are designed to avoid.
        """
        iters = len(agents)
        comp = self.sample_ecn_times(iters, net.N, rng)
        link = self.sample_link_times(iters, rng)
        return comp[np.arange(iters), np.asarray(agents, dtype=int)] + link

    # -- observed-response reward surface (DESIGN.md §15) ------------------

    @property
    def reward_cap(self) -> float:
        """Largest per-iteration wall-clock the reward surface resolves.

        ``epsilon`` (the longest an agent waits before the capped/fallback
        decode) plus one worst-case token hop ``comm_hi`` — both MODEL
        knobs, not properties of the hidden response distribution, so the
        controller may use the cap without peeking at the answer.
        """
        return self.epsilon + self.comm_hi

    def reward(self, dt) -> np.ndarray:
        """Per-iteration bandit reward: negative observed wall-clock,
        affinely mapped into [0, 1] (what UCB1/EXP3 confidence terms
        assume). ``dt`` is the observed iteration time (response + link);
        times at/above :attr:`reward_cap` clip to reward 0, an instant
        iteration scores 1. Monotone decreasing in ``dt``, so maximizing
        cumulative reward minimizes simulated running time.
        """
        d = np.clip(np.asarray(dt, dtype=float), 0.0, self.reward_cap)
        return 1.0 - d / self.reward_cap

    # -- event-driven schedules (DESIGN.md §13) ----------------------------

    def staleness_steps(
        self, times: np.ndarray, rng: np.random.Generator, n: int = 0
    ) -> np.ndarray:
        """Integer step delays under the bounded-staleness model.

        ``times`` is a run's cumulative clock (iters,), ``times[k]`` the
        simulated completion time of iteration k. The update emitted at
        iteration k is delayed by tau_k ~ U(0, tau_max] and lands at the
        LAST iteration boundary <= times[k] + tau_k, so the realized
        delay never exceeds ``tau_max`` — the hard bound of DESIGN.md
        §13 — and tau_max = 0 degenerates to delay 0 (land within the
        emitting iteration, the synchronous semantics). Delays are then
        clipped to ``staleness_cap - 1`` steps (the ring-buffer depth),
        which again only shortens them. Returns (iters,) int32, or
        (iters, n) with one independent delay per worker when ``n > 0``.
        """
        iters = len(times)
        shape = (iters, n) if n else (iters,)
        if self.tau_max <= 0:
            return np.zeros(shape, dtype=np.int32)
        tau = rng.uniform(0.0, self.tau_max, size=shape)
        land = (times[:, None] if n else times) + tau
        j = np.searchsorted(times, land.ravel(), side="right") - 1
        k = np.arange(iters)[:, None] if n else np.arange(iters)
        delta = j.reshape(shape) - k
        return np.clip(delta, 0, self.staleness_cap - 1).astype(np.int32)

    def sample_churn(
        self, starts: np.ndarray, n: int, rng: np.random.Generator
    ) -> np.ndarray:
        """(iters, n) bool up/down mask of an elastic fleet.

        Each worker alternates up-times ~ Exp(mean = 1/churn_rate) and
        down-times ~ Exp(mean = mttr) in continuous simulated time (an
        alternating-renewal crash/recover process; with ``mttr = 0`` the
        first crash is permanent — the worker *leaves*). The process is
        evaluated at ``starts`` — each iteration's simulated start time
        — so a worker crashed when an iteration begins sits that whole
        iteration out. Draw order (per worker: up, down, up, ...) is
        part of the seed contract (DESIGN.md §13).
        """
        iters = len(starts)
        up = np.ones((iters, n), dtype=bool)
        if self.churn_rate <= 0:
            return up
        horizon = float(starts[-1]) if iters else 0.0
        for w in range(n):
            toggles = []
            t, is_up = 0.0, True
            while t <= horizon:
                if is_up:
                    t += rng.exponential(1.0 / self.churn_rate)
                else:
                    t += rng.exponential(self.mttr)
                toggles.append(t)
                if is_up and self.mttr <= 0:
                    break  # permanent crash: no recovery draw
                is_up = not is_up
            cnt = np.searchsorted(np.asarray(toggles), starts, side="right")
            up[:, w] = cnt % 2 == 0
        return up


# Backwards-compatible names: the paper-era straggler model IS the
# homogeneous-uniform TimingModel (identical fields, identical draws).
StragglerModel = TimingModel


def sample_times(
    model: TimingModel, iters: int, K: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(ecn_times, link_times) for one run — the ADMM schedule's draws."""
    rng = np.random.default_rng(seed)
    return model.sample_ecn_times(iters, K, rng), model.sample_link_times(
        iters, rng
    )
