"""(Coded) stochastic incremental ADMM — paper Algorithms 1 & 2, eqs. (4)-(6).

PyTorch port of `repro.core.admm`. Covers, through the
`repro_torch.methods.admm.IncrementalADMM` kernel:

- **I-ADMM** (eq. 4, from [34]): exact x-minimization (closed form for least
  squares), incremental token traversal.
- **sI-ADMM** (Algorithm 1, eq. 5): linearized + proximal x-update with a
  mini-batch stochastic gradient assembled from K ECN partitions (eq. 6),
  tau^k = c_tau * sqrt(k), gamma^k = c_gamma / sqrt(k) (Theorem 2).
- **csI-ADMM** (Algorithm 2): ECNs compute *coded* partition gradients
  (fractional/cyclic MDS repetition schemes, `repro_torch.core.coding`); the
  agent decodes the exact mini-batch gradient from the fastest R = K - S
  responses.

This module owns the paper-facing pieces: the hyper-parameter config, the
per-iteration trace record, and the host-side schedule sampling (agents,
batches, decode vectors, timing — `make_schedule`). All of it is numpy and
bit-for-bit the reference's, so codes, schedules and timing draws agree
exactly with `repro`. The ONE device step lives in
`repro_torch.methods.admm`; serial and batched execution are derived from it
by `repro_torch.methods.driver`.

Update equations (active agent i = i_k, all others frozen):

  x_i^{k+1} = (tau^k x_i^k + rho z^k + y_i^k - G_i) / (rho + tau^k)   (5a)
  y_i^{k+1} = y_i^k + rho gamma^k (z^k - x_i^{k+1})                   (5b)
  z^{k+1}   = z^k + [ (x_i^{k+1}-x_i^k) - (y_i^{k+1}-y_i^k)/rho ] / N (4c)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .coding import GradientCode
from .graph import Network
from .problems import LeastSquaresProblem
from .timing import TimingModel, sample_times

__all__ = [
    "ADMMConfig",
    "Trace",
    "run_incremental_admm",
    "make_schedule",
]


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Hyper-parameters for (c)sI-ADMM (defaults follow paper §V)."""

    rho: float = 1.0
    c_tau: float = 0.1  # tau^k = c_tau * sqrt(k)
    c_gamma: float = 1.0  # gamma^k = c_gamma / sqrt(k)
    M: int = 60  # uncoded-equivalent mini-batch size per activation
    K: int = 3  # ECNs per agent
    S: int = 0  # tolerated stragglers (csI-ADMM); 0 => uncoded sI-ADMM
    scheme: str = "uncoded"  # key of repro.core.coding.CODE_FAMILIES
    exact_x: bool = False  # True => I-ADMM (closed-form x-update)
    traversal: str = "hamiltonian"  # or "shortest_path"
    seed: int = 0

    @property
    def M_bar(self) -> int:
        """Straggler-constrained batch size, eq. (22): M_bar = M/(S+1)."""
        return self.M // (self.S + 1)

    def validate(self) -> None:
        if self.M % ((self.S + 1) * self.K) != 0:
            raise ValueError(
                f"M={self.M} must be divisible by (S+1)*K="
                f"{(self.S + 1) * self.K}"
            )
        if self.scheme == "uncoded" and self.S != 0:
            raise ValueError("uncoded scheme cannot tolerate stragglers")


@dataclasses.dataclass
class Trace:
    """Per-iteration experiment record (all numpy, length = iters)."""

    accuracy: np.ndarray  # eq. (23) relative error
    test_error: np.ndarray  # MSE of the token z on the test set
    comm_cost: np.ndarray  # cumulative units (1 per full token hop)
    sim_time: np.ndarray  # cumulative simulated seconds
    z_err: np.ndarray  # ||z - x*|| / ||x*||
    final_x: np.ndarray  # (N, p, d)
    final_z: np.ndarray  # (p, d)

    def reduce(self, spec) -> dict:
        """Post-hoc streaming summaries of this trace.

        ``spec`` is a `repro_torch.methods.reductions.Reduction`; the
        result matches what the drivers' in-loop fold produces for the
        same run — the upgrade path from materialized to streaming sweeps.
        """
        from repro_torch.methods.reductions import reduce_trace  # no cycle

        return reduce_trace(spec, self)


def make_schedule(
    cfg: ADMMConfig,
    net: Network,
    code: GradientCode,
    straggler: TimingModel,
    iters: int,
    b: int,
) -> dict:
    """Host-side per-iteration schedule: agents, batches, decode vectors, time.

    Returns dict of numpy arrays consumed by the jitted scan + the
    time/communication accounting.

    With churn enabled on the timing model (DESIGN.md §13), ECNs and
    agents crash/recover as an alternating-renewal process sampled on
    the churn-free clock (seed stream [6, seed]; ECN draws before agent
    draws is part of the seed contract). Crashed ECNs never respond —
    their times are censored to +inf BEFORE the response/decode logic,
    so they are excluded from the alive mask and the per-pattern decode
    exactly like deadline-missing stragglers. Iterations whose surviving
    responses cannot be decoded (pattern below ``min_responses`` or
    outside the code family's decodable set) and iterations whose active
    agent is down are *skipped activations*: ``act = 0``, zero decode
    weights, and the token hop still pays its link time so the clock
    stays strictly increasing. An undecodable iteration records the
    epsilon cap as its wait (the agent gave up); a dead-agent iteration
    records zero compute.
    """
    K, S = cfg.K, cfg.S
    P = b // K  # partition size per ECN slot
    mu = cfg.M_bar // K  # per-partition sub-batch size
    nb = max(P // mu, 1)  # batches per partition (paper step 16)

    # --- agent traversal -------------------------------------------------
    if cfg.traversal == "hamiltonian":
        route = np.array(net.hamiltonian, dtype=np.int32)
    elif cfg.traversal == "shortest_path":
        route = np.array(net.shortest_path_cycle, dtype=np.int32)
    else:
        raise ValueError(f"unknown traversal {cfg.traversal!r}")
    reps = int(np.ceil(iters / len(route)))
    agents = np.tile(route, reps)[:iters]

    # --- mini-batch index (Algorithm 1 step 16 / Algorithm 2 step 15) ----
    cycle = np.arange(iters) // net.N  # cycle index m
    offsets = ((cycle % nb) * mu).astype(np.int32)

    # --- stragglers & decoding (vectorized over iterations) --------------
    ecn_t, link_t = sample_times(straggler, iters, K, seed=cfg.seed + 1)

    # --- churn (DESIGN.md §13): censor crashed workers -------------------
    act = np.ones(iters)
    if straggler.churn_rate > 0:
        churn_rng = np.random.default_rng([6, cfg.seed])
        # The churn process is realized on the churn-free clock (an
        # epsilon-capped provisional wait + the link hop) — documented
        # one-way approximation: crashes reshape response times, but
        # response times do not feed back into crash times.
        prov = np.cumsum(
            np.minimum(ecn_t.max(axis=1), straggler.epsilon) + link_t
        )
        starts = np.concatenate([[0.0], prov[:-1]])
        ecn_up = straggler.sample_churn(starts, K, churn_rng)
        agent_up = straggler.sample_churn(starts, net.N, churn_rng)
        act = agent_up[np.arange(iters), agents].astype(float)
        ecn_t = np.where(ecn_up, ecn_t, np.inf)

    if cfg.scheme == "uncoded":
        recv = ecn_t <= straggler.epsilon
        # nobody under the cap: wait for the fastest ECN
        none = ~recv.any(axis=1)
        all_dead = np.isinf(ecn_t).all(axis=1)
        fb = none & ~all_dead
        recv[fb, np.argmin(ecn_t[fb], axis=1)] = True
        decode = recv * (
            K / np.maximum(recv.sum(axis=1, keepdims=True), 1)
        )
        # Response = slowest counted ECN, capped at epsilon — except the
        # fallback rows, where the agent actually waited out the fastest
        # ECN's full (> epsilon) response; record that true wait.
        resp = np.minimum(ecn_t.max(axis=1), straggler.epsilon)
        resp = np.where(fb, ecn_t.min(axis=1), resp)
        if all_dead.any():  # every ECN crashed: skipped activation
            act = act * ~all_dead
            resp = np.where(all_dead, straggler.epsilon, resp)
        alive = recv
    else:
        order = np.argsort(ecn_t, axis=1)
        alive = np.zeros((iters, K), dtype=bool)
        np.put_along_axis(alive, order[:, : code.R], True, axis=1)
        # Crashed ECNs never respond: their +inf times sort last, but
        # when fewer than R survive they still land in the top-R slots —
        # strike them from the alive set so decode sees only responders.
        alive &= np.isfinite(ecn_t)
        # response time = the R-th fastest ECN, capped at epsilon
        r_th = np.take_along_axis(ecn_t, order[:, code.R - 1 : code.R], axis=1)
        resp = np.minimum(r_th[:, 0], straggler.epsilon)
        # Deadline-aware decode (DESIGN.md §11): with a partial-recovery
        # code, an iteration whose R-th response misses the deadline but
        # that has >= r_min arrivals decodes *at the deadline* from the
        # arrived set (certified bounded error) — the recorded response
        # is the deadline itself, not the R-th ECN's wait. Fewer than
        # r_min arrivals fall back to the exact wait; exact-only
        # families (min_responses == R) never take this branch.
        dl = straggler.deadline
        if dl is not None and code.min_responses < code.R:
            arrived = ecn_t <= dl
            n_arr = arrived.sum(axis=1)
            # "whichever fires first": the deadline only fires when it
            # strictly beats the exact path's recorded wait — n_arr < R
            # guarantees the R-th ECN is later, but the epsilon cap
            # could still undercut a deadline armed above epsilon.
            use_dl = (
                (n_arr >= code.min_responses)
                & (n_arr < code.R)
                & (dl < resp)
            )
            alive = np.where(use_dl[:, None], arrived, alive)
            resp = np.where(use_dl, dl, resp)
        # Decode vectors depend only on the alive pattern, so solve the
        # lstsq once per distinct pattern — a sweep samples thousands of
        # iterations but only ever sees C(K, S)-ish patterns (plus the
        # deadline-truncated and churn-censored ones). Under churn a
        # surviving pattern can fall outside the family's decodable set
        # (too few responders, or a subset the code cannot invert):
        # those iterations become skipped activations with zero decode
        # weights, recording the epsilon cap as the agent's futile wait.
        patterns, inverse = np.unique(alive, axis=0, return_inverse=True)
        vecs, decodable = [], []
        for a in patterns:
            vec = None
            if a.sum() >= code.min_responses:
                try:
                    vec = code.decode_vector(a)
                except ValueError:
                    vec = None
            decodable.append(vec is not None)
            vecs.append(vec if vec is not None else np.zeros(K))
        decode = np.stack(vecs)[inverse]
        ok = np.asarray(decodable)[inverse]
        if not ok.all():
            act = act * ok
            resp = np.where(ok, resp, straggler.epsilon)

    if straggler.churn_rate > 0:
        # Dead-agent iterations: no compute happens; the token hop alone
        # advances the clock. Zero the decode row too so the (gated)
        # device step never consumes a stale weight.
        agent_dead = act == 0.0
        resp = np.where(
            agent_up[np.arange(iters), agents], resp, 0.0
        )
        decode = np.where(agent_dead[:, None], 0.0, decode)

    tau = cfg.c_tau * np.sqrt(np.arange(1, iters + 1))
    gamma = cfg.c_gamma / np.sqrt(np.arange(1, iters + 1))

    return dict(
        agents=agents,
        offsets=offsets,
        decode=decode,
        alive=alive,
        act=act,
        tau=tau,
        gamma=gamma,
        resp_time=resp,
        link_time=link_t,
        mu=mu,
        P=P,
    )


def run_incremental_admm(
    problem: LeastSquaresProblem,
    net: Network,
    cfg: ADMMConfig,
    iters: int,
    straggler: Optional[TimingModel] = None,
    code: Optional[GradientCode] = None,
    **device_kw,
) -> Trace:
    """Run I-/sI-/csI-ADMM for ``iters`` activations and return the trace.

    Thin serial entry over the method kernel (lazy import:
    `repro_torch.methods` imports this module for the config/trace/schedule
    types). ``device_kw`` (``device``, ``dtype``) go to
    `repro_torch.methods.run_serial`.
    """
    from repro_torch.methods import get_kernel, run_serial
    from repro_torch.methods.admm import ADMMRun

    # sI-/csI-/I-ADMM are one registered kernel instance; the behavioral
    # switches (exact_x, scheme, S) all live in cfg.
    return run_serial(
        get_kernel("sI-ADMM"), problem, net, ADMMRun(cfg, straggler, code),
        iters, **device_kw,
    )
