"""Named sweeps: the paper figures on the main path.

PyTorch port of `repro.experiments.registry`, limited to the sweeps of the
ported slice: ``fig3_minibatch``, ``fig3_stragglers``, ``fig4_stragglers``
and ``fig5`` (the reference's registry.py:26-135). The baseline and
beyond-paper grids follow their methods in later slices (ROADMAP
Queue 1). Each factory returns a `SweepSpec`; pass ``iters=``/``runs=``
overrides for smoke runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

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


SWEEPS: Dict[str, Callable[..., SweepSpec]] = {
    "fig3_minibatch": fig3_minibatch,
    "fig3_stragglers": fig3_stragglers,
    "fig4_stragglers": fig4_stragglers,
    "fig5": fig5,
}


def get_sweep(name: str, **overrides) -> SweepSpec:
    """Look up a named sweep; ``overrides`` go to the factory (iters/runs)."""
    if name not in SWEEPS:
        raise KeyError(
            f"unknown or not yet ported sweep {name!r}; ported: "
            f"{sorted(SWEEPS)}"
        )
    return SWEEPS[name](**overrides)
