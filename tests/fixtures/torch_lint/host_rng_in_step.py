"""BAD: torch's generator inside a device-side step body.

Noise drawn in the step comes from torch's generator, not from the
numpy streams `prepare` samples for `repro`'s bitwise-equal schedules;
sample it host-side in prepare() and pass it as a step input.
"""

import numpy as np
import torch


class RngKernel(MethodKernel):  # noqa: F821 — AST fixture, never imported
    name = "rng-fixture"

    def prepare(self, problem, net, cfg, iters):
        return Prepared(  # noqa: F821
            consts=(np.zeros(3),), steps=(),
            statics=dict(name=self.name, iters=iters),
        )

    def step(self, state, inp, aux, statics):
        noise = torch.randn_like(state)  # <-- host-rng-in-device-code
        return state + noise, state
