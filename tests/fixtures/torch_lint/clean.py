"""GOOD: a kernel that honours every trace contract of the port.

numpy sampling in prepare, a torch step that branches only on statics
and on Python-level facts of a tensor (its shape, dtype, device), a
frozen spec dataclass, and every statics key the step reads produced by
prepare. `tests/test_torch_analysis.py` asserts zero findings here — the
linter's false-positive guard.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TidyRun:
    rho: float = 1.0
    damped: bool = False


class TidyKernel(MethodKernel):  # noqa: F821 — AST fixture, never imported
    name = "tidy-fixture"

    def prepare(self, problem, net, cfg, iters):
        rng = np.random.default_rng(0)
        steps = rng.normal(size=(iters, 3))
        return Prepared(  # noqa: F821
            consts=(steps.sum(0),),
            steps=(steps,),
            statics=dict(name=self.name, iters=iters, damped=cfg.damped),
        )

    def init(self, aux, statics):
        return torch.zeros_like(aux[0])

    def step(self, state, inp, aux, statics):
        x = state + torch.tanh(inp[0])
        if statics["damped"]:  # statics branch: Python-level
            x = x * 0.5
        if x.shape[0] > 1 and x.dtype == torch.float64:  # static facts
            x = x - x.mean()
        if x.device.type == "cuda" and x.size(0) > int(statics["iters"]):
            x = x.clone()
        x = torch.where(x > 1.0, torch.ones_like(x), x)  # no host branch
        return x, (x, x, x)

    def final(self, state, aux, statics):
        return state, state
