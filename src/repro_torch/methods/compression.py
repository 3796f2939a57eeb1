"""cq-sI-ADMM: communication-compressed token updates (arXiv 2501.13516).

PyTorch port of `repro.methods.compression`. The token increment dz an
agent would transmit (eq. 4c) is compressed before it is applied, with an
error-feedback accumulator so the compression error is re-injected
instead of lost. Two compressors, written over the leading runs axis R:

- ``topk``: keep the ceil(frac * p*d) largest-|.| entries of each run's
  residual-corrected increment. Among equal magnitudes the lower index
  wins, as in `jax.lax.top_k`: the selection is a stable descending sort,
  whose order does not depend on the device (`torch.topk` makes no
  promise about ties).
- ``quant``: stochastic uniform quantization to 2^bits - 1 levels of
  |u|/max|u|, the scale max|u| per run, with the rounding uniforms
  sampled HOST-side per step on stream [3, seed] (`Prepared.steps`), bit
  for bit the reference's.

Communication accounting and the statics are the reference's exactly: a
topk hop costs k*(32 + log2(p*d))/(32*p*d) units, a quant hop
((bits+1)*p*d + 32)/(32*p*d) units, versus 1 unit for a dense fp32
token. The coded mini-batch machinery and the fused x-update kernel are
inherited from `repro_torch.methods.admm.IncrementalADMM`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .admm import ADMMRun, IncrementalADMM
from .base import register

__all__ = ["CompressionRun", "CompressedADMM", "CQ_SI_ADMM", "topk_mask"]


@dataclasses.dataclass(frozen=True)
class CompressionRun(ADMMRun):
    """ADMM run config + token compressor choice."""

    compressor: str = "topk"  # "topk" | "quant"
    frac: float = 0.25  # topk: fraction of token entries kept
    bits: int = 8  # quant: bits per transmitted entry


def topk_mask(flat: torch.Tensor, k: int) -> torch.Tensor:
    """(R, n) -> (R, n) mask, 1 on each row's k largest |entries| (lower
    index first among ties, as `jax.lax.top_k`), 0 elsewhere."""
    idx = torch.sort(flat.abs(), dim=1, descending=True, stable=True).indices
    return torch.zeros_like(flat).scatter_(1, idx[:, :k], 1.0)


class CompressedADMM(IncrementalADMM):
    name = "cq-sI-ADMM"

    def config(self, case) -> CompressionRun:
        return CompressionRun(
            case.admm_config(),
            case.timing_model(),
            compressor=case.compressor,
            frac=case.frac,
            bits=case.bits,
        )

    def static_signature(self, problem, run: CompressionRun, iters) -> tuple:
        base = super().static_signature(problem, run, iters)
        if run.compressor == "topk":
            return base + ("topk", self._k_keep(run, problem))
        return base + ("quant", run.bits)

    @staticmethod
    def _k_keep(run: CompressionRun, problem) -> int:
        if not 0.0 < run.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {run.frac}")
        return max(1, math.ceil(run.frac * problem.p * problem.d))

    def _statics(self, run: CompressionRun, problem, iters, sched) -> dict:
        statics = super()._statics(run, problem, iters, sched)
        statics["compressor"] = run.compressor
        if run.compressor == "topk":
            statics["k_keep"] = self._k_keep(run, problem)
        elif run.compressor == "quant":
            if run.bits < 1:
                raise ValueError(f"bits must be >= 1, got {run.bits}")
            statics["levels"] = 2 ** run.bits - 1
        else:
            raise ValueError(f"unknown compressor {run.compressor!r}")
        return statics

    def _extra_steps(self, run: CompressionRun, problem, iters, steps):
        if run.compressor != "quant":
            return steps
        # [tag, seed] sequence: disjoint from every scalar-seeded stream
        # (schedule, stragglers) and from privacy's [2, seed].
        rng = np.random.default_rng([3, run.cfg.seed])
        unif = rng.random((iters, problem.p, problem.d))
        return steps + (unif.astype(problem.O.dtype),)

    def _comm_per_iter(self, run: CompressionRun, problem) -> float:
        pd = problem.p * problem.d
        if run.compressor == "topk":
            # Each kept entry ships its 32-bit value plus a log2(p*d)-bit
            # index, relative to the 32*p*d-bit dense token.
            idx_bits = max(1, math.ceil(math.log2(pd)))
            return self._k_keep(run, problem) * (32 + idx_bits) / (32 * pd)
        # Sign + magnitude per entry, plus one fp32 scale per token.
        return ((run.bits + 1) * pd + 32) / (32 * pd)

    def init(self, aux, statics):
        state = super().init(aux, statics)
        state["e"] = torch.zeros_like(state["z"])  # compression residual
        return state

    def _token_increment(self, state, dz, inp, aux, statics):
        u = dz + state["e"]  # error feedback: re-inject past residual
        if statics["compressor"] == "topk":
            flat = u.reshape(u.shape[0], -1)
            c = (flat * topk_mask(flat, statics["k_keep"])).reshape(u.shape)
        else:
            L = statics["levels"]
            scale = u.abs().amax(dim=(1, 2))[:, None, None]  # per run
            y = u.abs() / scale.clamp_min(1e-30) * L
            q = torch.floor(y + inp[6])  # stochastic rounding
            c = torch.where(
                scale > 0.0, torch.sign(u) * q * scale / L, torch.zeros_like(u)
            )
        return {"e": u - c}, c


CQ_SI_ADMM = register(CompressedADMM())
