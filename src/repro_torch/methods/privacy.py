"""pI-ADMM: privacy-perturbed incremental ADMM (arXiv 2003.10615).

PyTorch port of `repro.methods.privacy`. The active agent perturbs the
primal variable it shares with Gaussian noise before the dual/token
updates. The noise standard deviation decays as sigma_k = sigma / sqrt(k)
and is sampled HOST-side per iteration on stream [2, seed]
(`Prepared.steps`), bit for bit the reference's draws, so the device step
only adds it.

Everything else (mini-batch oracle, coding, straggler timing, the fused
x-update kernel) is inherited from
`repro_torch.methods.admm.IncrementalADMM`: the privacy variant is the
sI-ADMM step plus one hook.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .admm import ADMMRun, IncrementalADMM
from .base import register

__all__ = ["PrivacyRun", "PrivateADMM", "PI_ADMM"]


@dataclasses.dataclass(frozen=True)
class PrivacyRun(ADMMRun):
    """ADMM run config + primal perturbation scale (noise std at k=1)."""

    sigma: float = 0.01


class PrivateADMM(IncrementalADMM):
    name = "pI-ADMM"

    def config(self, case) -> PrivacyRun:
        return PrivacyRun(
            case.admm_config(), case.timing_model(), sigma=case.sigma
        )

    def _extra_steps(
        self, run: PrivacyRun, problem, iters, steps: tuple
    ) -> tuple:
        # Composite seed sequence: scalar-seeded streams (schedule uses
        # cfg.seed, stragglers cfg.seed + 1) never collide with [tag, seed]
        # sequences, so multi-seed grid arms stay independent.
        rng = np.random.default_rng([2, run.cfg.seed])
        dt = problem.O.dtype
        sigma_k = run.sigma / np.sqrt(np.arange(1, iters + 1))
        noise = sigma_k[:, None, None] * rng.standard_normal(
            (iters, problem.p, problem.d)
        )
        return steps + (noise.astype(dt),)

    def _perturb_x(self, x_new, inp, aux, statics):
        return x_new + inp[6]


PI_ADMM = register(PrivateADMM())
