"""Named sweeps: the paper figures + beyond-paper grids.

PyTorch port of `repro.experiments.registry`, all 17 of its sweeps: the
paper's figures (``fig3_minibatch``, ``fig3_baselines``,
``fig3_stragglers``, ``fig3e_runtime``, ``fig4_baselines``,
``fig4_stragglers``, ``fig5``) and the beyond-paper grids
``topology_grid``, ``privacy_grid``, ``code_frontier``,
``adaptive_frontier`` (bandit control), ``compression_grid``,
``hetero_grid``, ``mesh_scale``, ``fleet_frontier`` (streaming reductions
at fleet scale), ``staleness_frontier`` and ``churn_grid`` (async mode).
Each factory returns a `SweepSpec`; pass ``iters=``/``runs=`` overrides
for smoke runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.methods.reductions import Reduction

from .sweep import Case, SweepSpec

__all__ = ["SWEEPS", "get_sweep"]


def _coded_scheme(c: Case) -> Case:
    """S=0 runs uncoded; S>0 keeps the requested coded scheme."""
    return dataclasses.replace(c, scheme="uncoded" if c.S == 0 else c.scheme)


def fig3_minibatch(iters: int = 1500, runs: int = 1) -> SweepSpec:
    """Fig. 3(a)+(b): sI-ADMM mini-batch sweep on USPS(-standin)."""
    return SweepSpec(
        "fig3_minibatch",
        Case(method="sI-ADMM", dataset="usps", iters=iters),
        axes={"M": [6, 30, 60, 90], "seed": list(range(runs))},
        description="accuracy/test-error vs iterations for M in {6,30,60,90}",
    )


def _gossip_iters(c: Case) -> Case:
    """Gossip methods update every agent per iteration — the paper plots
    them at 1/10 the incremental iteration count (equal-work comparison);
    D-ADMM uses rho=0.1, DGD/EXTRA alpha=0.05."""
    if c.method in ("D-ADMM", "DGD", "EXTRA"):
        c = dataclasses.replace(c, iters=max(c.iters // 10, 1), rho=0.1)
    return c


def fig3_baselines(iters: int = 1500, runs: int = 1) -> SweepSpec:
    """Fig. 3(c)+(d): sI-ADMM vs W-ADMM / D-ADMM / DGD / EXTRA on USPS."""
    return SweepSpec(
        "fig3_baselines",
        Case(dataset="usps", iters=iters, alpha=0.05),
        axes={
            "method": ["sI-ADMM", "W-ADMM", "D-ADMM", "DGD", "EXTRA"],
            "seed": list(range(runs)),
        },
        fixup=_gossip_iters,
        description="accuracy vs communication cost, incremental vs gossip",
    )


def fig3_stragglers(iters: int = 1500, runs: int = 1) -> SweepSpec:
    """Fig. 3(e): running time under straggler delay, coded vs uncoded.

    fractional repetition needs (S+1) | K, so it runs with K=4 ECNs
    (M=48 keeps M divisible by (S+1)*K).
    """
    return SweepSpec(
        "fig3_stragglers",
        Case(
            method="csI-ADMM", dataset="usps", iters=iters,
            p_straggle=0.3, delay=5e-3,
        ),
        axes={
            "scheme": [
                {"scheme": "uncoded", "S": 0, "K": 3, "M": 60},
                {"scheme": "cyclic", "S": 1, "K": 3, "M": 60},
                {"scheme": "fractional", "S": 1, "K": 4, "M": 48},
            ],
            "epsilon": [2e-3, 5e-3, 1e-2],
            "seed": list(range(runs)),
        },
        description="sim running time vs max straggler delay epsilon",
    )


def fig4_baselines(iters: int = 1200, runs: int = 1) -> SweepSpec:
    """Fig. 4: the Fig. 3(c)/(d) comparison on ijcnn1(-standin)."""
    return SweepSpec(
        "fig4_baselines",
        Case(dataset="ijcnn1", iters=iters, alpha=0.05),
        axes={
            "method": ["sI-ADMM", "W-ADMM", "D-ADMM", "DGD", "EXTRA"],
            "seed": list(range(runs)),
        },
        fixup=_gossip_iters,
        description="fig3 baseline comparison at ijcnn1 scale",
    )


def fig4_stragglers(iters: int = 1200, runs: int = 1) -> SweepSpec:
    """Fig. 4 straggler pair: uncoded vs cyclic on ijcnn1."""
    return SweepSpec(
        "fig4_stragglers",
        Case(
            method="csI-ADMM", dataset="ijcnn1", iters=iters,
            p_straggle=0.3, delay=5e-3, epsilon=1e-2,
        ),
        axes={
            "scheme": [
                {"scheme": "uncoded", "S": 0},
                {"scheme": "cyclic", "S": 1},
            ],
            "seed": list(range(runs)),
        },
        description="straggler robustness at ijcnn1 scale",
    )


def fig5(iters: int = 1200, runs: int = 4) -> SweepSpec:
    """Fig. 5: straggler tolerance S vs convergence (synthetic, K=6).

    M_bar = M/(S+1) (eq. 22): more tolerance => smaller effective batch =>
    slower convergence (Corollary 2). Cyclic repetition works for any
    (K, S); fractional would require (S+1) | K (fails at S=3, K=6).
    """
    return SweepSpec(
        "fig5",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360,
            scheme="cyclic", c_tau=0.5, iters=iters,
        ),
        axes={"S": [0, 1, 2, 3], "seed": list(range(runs))},
        fixup=_coded_scheme,
        description="straggler count vs convergence speed, 4-seed average",
    )


def topology_grid(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Beyond-paper: topology connectivity x S x scheme grid (synthetic).

    The paper fixes eta=0.5; this grid crosses sparse/medium/dense
    topologies with straggler tolerance and both repetition schemes in
    one engine call. Shortest-path-cycle traversal makes connectivity
    bite (the Hamiltonian ring is planted identically at every eta; only
    relay hops differ across topologies). Note the two coded schemes
    produce IDENTICAL accuracy curves by construction — both decode the
    exact gradient — and differ in simulated response time and storage
    replication only.
    """
    return SweepSpec(
        "topology_grid",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360,
            c_tau=0.5, iters=iters, traversal="shortest_path",
        ),
        axes={
            "connectivity": [0.3, 0.6, 0.9],
            "S": [0, 1, 2],
            "scheme": ["cyclic", "fractional"],
            "seed": list(range(runs)),
        },
        fixup=_coded_scheme,
        description="beyond-paper topology x straggler x scheme grid",
    )


def privacy_grid(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Beyond-paper: pI-ADMM privacy noise x straggler tolerance grid.

    Gaussian primal perturbation (arXiv 2003.10615) with std decaying as
    sigma/sqrt(k), crossed with the coded straggler tolerance S — the
    privacy mechanism and the coding layer compose because the kernel
    inherits the full csI-ADMM data path (DESIGN.md §8). sigma=0 is the
    exact sI-/csI-ADMM iterate path (the noise-free control arm).
    """
    return SweepSpec(
        "privacy_grid",
        Case(
            method="pI-ADMM", dataset="usps", K=3, M=60, scheme="cyclic",
            iters=iters,
        ),
        axes={
            "sigma": [0.0, 0.01, 0.05, 0.2],
            "S": [0, 1],
            "seed": list(range(runs)),
        },
        fixup=_coded_scheme,
        description="privacy noise sigma x straggler tolerance S for pI-ADMM",
    )


def compression_grid(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Beyond-paper: cq-sI-ADMM token compression x topology grid.

    Quantized (4/8-bit stochastic) and top-k sparsified token updates
    (arXiv 2501.13516) with error feedback, across sparse/medium/dense
    topologies (shortest-path-cycle traversal, so connectivity bites via
    relay hops — same rationale as `topology_grid`). comm_cost rows
    account compressed hops at their true bit cost including side
    information (top-k indices, quantization sign + scale; see
    `repro_torch.methods.compression`), so accuracy-vs-communication
    comparisons against sI-ADMM are honest.
    """
    return SweepSpec(
        "compression_grid",
        Case(
            method="cq-sI-ADMM", dataset="usps", K=3, M=60, iters=iters,
            traversal="shortest_path",
        ),
        axes={
            "compressor": [
                {"compressor": "quant", "bits": 4},
                {"compressor": "quant", "bits": 8},
                {"compressor": "topk", "frac": 0.25},
            ],
            "connectivity": [0.3, 0.6, 0.9],
            "seed": list(range(runs)),
        },
        description="token compression (bits / top-k) x topology grid",
    )


def _frontier_deadline(c: Case) -> Case:
    """Exact-only families ignore the decode deadline (it is a no-op in
    the schedule), so their deadline grid points merge into one case;
    S=0 points run uncoded as everywhere else."""
    c = _coded_scheme(c)
    if c.scheme != "approx":
        c = dataclasses.replace(c, deadline=None)
    return c


def code_frontier(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Beyond-paper headline: code family x S x decode deadline frontier.

    Every registered exact family (cyclic S+1-replication, MDS full
    replication) against the partial-recovery `approx` family with and
    without a decode deadline (DESIGN.md §11): the deadline trades a
    certified decode error for never waiting past `deadline` seconds on
    a straggling R-th ECN, so the accuracy-vs-sim_time frontier shows
    where bounded-error decoding beats waiting. All axes are host-side
    (decode weights, masks, clocks), so the whole grid is ONE dispatch
    — same static signature as the fig5 family.
    """
    return SweepSpec(
        "code_frontier",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360,
            scheme="cyclic", c_tau=0.5, iters=iters,
            p_straggle=0.3, delay=5e-3,
        ),
        axes={
            "scheme": ["cyclic", "mds", "approx"],
            "S": [1, 2],
            "deadline": [None, 3e-4, 1e-3],
            "seed": list(range(runs)),
        },
        fixup=_frontier_deadline,
        description="code family x straggler tolerance x decode deadline",
        x_axis="sim_time",
    )


# The code_frontier grid's distinct cells as a controller arm set: the
# exact cyclic family at both straggler tolerances plus the
# partial-recovery family under both decode deadlines (DESIGN.md §15).
# (mds cells are omitted: an exact decode at R responses observes the
# identical response clock as cyclic at equal S — a duplicate arm.)
FRONTIER_ARMS = (
    ("cyclic", 1, None),
    ("cyclic", 2, None),
    ("approx", 1, 3e-4),
    ("approx", 1, 1e-3),
    ("approx", 2, 3e-4),
    ("approx", 2, 1e-3),
)


def adaptive_frontier(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Beyond-paper headline: ONLINE selection over the code_frontier.

    The a-csI-ADMM controller runs the exact `code_frontier` fleet —
    same problem, same straggler regime, same seeds — but must FIND the
    best (family, S, deadline) cell from observed iteration wall-clock
    instead of being told: the response distribution is hidden from the
    bandit, which only sees the reward of the arm it pulls. Both
    policies per seed; each policy is one static group, so the whole
    grid is TWO step loops. Headline gate
    (EXPERIMENTS.md 'Adaptive control'): accuracy-at-time-budget within
    10% of the best fixed cell, strictly better than the worst.
    """
    return SweepSpec(
        "adaptive_frontier",
        Case(
            method="a-csI-ADMM", dataset="synthetic", K=6, M=360,
            scheme="cyclic", c_tau=0.5, iters=iters,
            p_straggle=0.3, delay=5e-3, arms=FRONTIER_ARMS,
            # Tuned on the host replay for THIS fleet's reward gaps
            # (best-vs-second mean-reward gap ~0.01): UCB1's default
            # c=0.5 over-explores 6 close arms; EXP3 needs a hotter
            # learning rate and less forced exploration to separate
            # the top cluster within 800 pulls.
            bandit_c=0.1, bandit_eta=0.15, bandit_gamma=0.05,
        ),
        axes={
            "bandit": ["ucb1", "exp3"],
            "seed": list(range(runs)),
        },
        description="online bandit control over the code/deadline frontier",
        x_axis="sim_time",
    )


def mesh_scale(iters: int = 600, runs: int = 16) -> SweepSpec:
    """Beyond-paper: the fig5 grid at mesh scale (48 runs default — the
    2x2x16 axis product is 64 grid points, but the `_coded_scheme` fixup
    merges the S=0 cyclic/fractional points into one uncoded case).

    Built to saturate several devices: S x scheme x 16 seeds is one
    static group, so the whole grid is ONE step loop whose runs axis
    splits evenly over 1/2/4/8 devices in the sharded mode.
    """
    return SweepSpec(
        "mesh_scale",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360,
            scheme="cyclic", c_tau=0.5, iters=iters,
        ),
        axes={
            "S": [0, 1],
            "scheme": ["cyclic", "fractional"],
            "seed": list(range(runs)),
        },
        fixup=_coded_scheme,
        description="fig5-style grid sized for mesh-sharded execution",
    )


def fig3e_runtime(iters: int = 1500, runs: int = 2) -> SweepSpec:
    """Fig. 3(e) completed: ALL five fig3 methods on the running-time axis.

    The paper's headline running-time claim compares csI-/sI-ADMM against
    the state-of-the-art baselines; this sweep puts every fig3 method on
    the unified simulated clock (DESIGN.md §10) so
    ``reduce_mean(..., x="sim_time")`` yields the seed-averaged
    accuracy-vs-running-time curves and the accuracy-at-time-budget
    readout (EXPERIMENTS.md 'Running time').
    """
    return SweepSpec(
        "fig3e_runtime",
        Case(
            dataset="usps", iters=iters, alpha=0.05,
            p_straggle=0.3, delay=5e-3,
        ),
        axes={
            "method": ["sI-ADMM", "W-ADMM", "D-ADMM", "DGD", "EXTRA"],
            "seed": list(range(runs)),
        },
        fixup=_gossip_iters,
        description="accuracy vs simulated running time, all fig3 methods",
        x_axis="sim_time",
    )


def hetero_grid(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Beyond-paper: heterogeneous-fleet grid — speed-class mix x S x scheme.

    Shifted-exponential ECN responses (the coded-computing response model,
    arXiv 2107.00481) with per-ECN speed classes assigned round-robin:
    (1.0,) is the paper's homogeneous fleet, (1.0, 2.0) alternates 2x
    slower ECNs, (1.0, 1.0, 4.0) plants one 4x straggler class per
    triple. Crossed with straggler tolerance S and both repetition
    schemes — the regime where coding should pay off most, since slow
    classes are *persistently* slow rather than transiently delayed.
    Speed classes only touch the host-side clock, so the whole grid
    still shares ONE static signature / dispatch.
    """
    return SweepSpec(
        "hetero_grid",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360,
            scheme="cyclic", c_tau=0.5, iters=iters,
            p_straggle=0.3, delay=5e-3, response="shifted_exp",
        ),
        axes={
            "speed_classes": [(1.0,), (1.0, 2.0), (1.0, 1.0, 4.0)],
            "S": [0, 1, 2],
            "scheme": ["cyclic", "fractional"],
            "seed": list(range(runs)),
        },
        fixup=_coded_scheme,
        description="ECN speed-class mix x straggler tolerance x scheme",
        x_axis="sim_time",
    )


def fleet_frontier(iters: int = 1000, runs: int = 1000) -> SweepSpec:
    """Fleet-scale headline: heavy-tailed fleets x code family x S.

    The regime the streaming-reduction layer exists for: thousands of
    independent straggler realizations (2 response tails x 3 code
    families x 2 tolerances x ``runs`` seeds = 12 x runs grid points) at
    agent populations where materializing per-iteration Traces would be
    O(iters x runs) memory. The declared `Reduction` keeps everything
    the frontier needs — accuracy/test-error at sim-time budgets,
    time-to-accuracy targets, trajectory quantiles — in O(grid) memory,
    so the default grid (12,000 runs) runs in a handful of chunks under
    REPRO_SHARD_MEM_MB (EXPERIMENTS.md 'Fleet scale'). Lognormal vs
    Pareto base responses (finite vs infinite variance) with a planted
    4x speed class, against cyclic/MDS exact decoding and the
    deadline-truncated approximate family (DESIGN.md §11).
    """
    return SweepSpec(
        "fleet_frontier",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360,
            scheme="cyclic", c_tau=0.5, iters=iters,
            p_straggle=0.3, delay=5e-3, speed_classes=(1.0, 1.0, 4.0),
        ),
        axes={
            "response": ["lognormal", "pareto"],
            "scheme": [
                {"scheme": "cyclic"},
                {"scheme": "mds"},
                {"scheme": "approx", "deadline": 3e-4},
            ],
            "S": [1, 2],
            "seed": list(range(runs)),
        },
        description="heavy-tailed fleet x code family x S, streaming "
        "reductions at fleet scale",
        x_axis="sim_time",
        reductions=Reduction(
            fields=("accuracy", "test_error"),
            budgets=(0.25, 0.5, 1.0, 2.0),
            x="sim_time",
            targets=(0.5, 0.2, 0.1),
            quantiles=(0.1, 0.5, 0.9),
        ),
    )


def staleness_frontier(iters: int = 800, runs: int = 2) -> SweepSpec:
    """Event-driven headline: convergence vs staleness bound x method.

    csI-ADMM's token and the gossip methods' broadcasts land with a
    bounded simulated delay tau ~ U(0, tau_max]; tau_max = 0 is the
    bulk-synchronous control arm and keeps the synchronous path (and
    static signature), so each method contributes exactly two groups:
    one sync, one async ring. All schedules are host-side step inputs —
    the whole async half of the grid per method is ONE step loop however
    many tau_max values it spans.
    """
    return SweepSpec(
        "staleness_frontier",
        Case(
            method="csI-ADMM", dataset="usps", K=3, M=60, scheme="cyclic",
            S=1, alpha=0.05, iters=iters, p_straggle=0.3, delay=5e-3,
        ),
        axes={
            "method": ["csI-ADMM", "D-ADMM", "DGD", "EXTRA"],
            "tau_max": [0.0, 5e-4, 2e-3, 8e-3],
            "seed": list(range(runs)),
        },
        fixup=_gossip_iters,
        description="staleness bound tau_max x method, sync arm bit-exact",
        x_axis="sim_time",
    )


def churn_grid(iters: int = 800, runs: int = 3) -> SweepSpec:
    """Event-driven headline: accuracy under churn rate x code family.

    Agents and ECNs crash/recover as an alternating-renewal process
    (mean uptime 1/churn_rate, mean repair mttr); crashed ECNs are
    censored from the alive mask before decode, so each family's
    decodable-pattern set is what is being stress-tested: cyclic decodes
    only contiguous-ish R-subsets, MDS any R survivors, and the approx
    family's deadline decode degrades gracefully below R. churn_rate = 0
    is the synchronous control arm (the sync path).
    """
    return SweepSpec(
        "churn_grid",
        Case(
            method="csI-ADMM", dataset="synthetic", K=6, M=360, S=2,
            scheme="cyclic", c_tau=0.5, iters=iters,
            p_straggle=0.3, delay=5e-3, mttr=0.05,
        ),
        axes={
            "scheme": [
                {"scheme": "cyclic"},
                {"scheme": "mds"},
                {"scheme": "approx", "deadline": 3e-4},
            ],
            "churn_rate": [0.0, 5.0, 25.0],
            "seed": list(range(runs)),
        },
        description="churn rate x code family under elastic-fleet decode",
        x_axis="sim_time",
    )


SWEEPS: Dict[str, Callable[..., SweepSpec]] = {
    "fig3_minibatch": fig3_minibatch,
    "fig3_baselines": fig3_baselines,
    "fig3_stragglers": fig3_stragglers,
    "fig3e_runtime": fig3e_runtime,
    "fig4_baselines": fig4_baselines,
    "fig4_stragglers": fig4_stragglers,
    "fig5": fig5,
    "topology_grid": topology_grid,
    "privacy_grid": privacy_grid,
    "code_frontier": code_frontier,
    "adaptive_frontier": adaptive_frontier,
    "compression_grid": compression_grid,
    "hetero_grid": hetero_grid,
    "mesh_scale": mesh_scale,
    "fleet_frontier": fleet_frontier,
    "staleness_frontier": staleness_frontier,
    "churn_grid": churn_grid,
}


def get_sweep(name: str, **overrides) -> SweepSpec:
    """Look up a named sweep; ``overrides`` go to the factory (iters/runs)."""
    if name not in SWEEPS:
        raise KeyError(
            f"unknown sweep {name!r}; known: "
            f"{sorted(SWEEPS)}"
        )
    return SWEEPS[name](**overrides)
