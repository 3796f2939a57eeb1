"""BAD: a tensor made on the host side of the split.

prepare() is numpy by contract: the driver stacks its outputs on a
leading runs axis and `prepared_to_device` makes the tensors on the
requested device; a tensor here is made before that layout is known.
"""

import numpy as np
import torch


class EagerKernel(MethodKernel):  # noqa: F821 — AST fixture, never imported
    name = "eager-fixture"

    def prepare(self, problem, net, cfg, iters):
        data = torch.as_tensor(np.ones(4))  # <-- device-tensor-in-host-prepare
        return Prepared(  # noqa: F821
            consts=(data,), steps=(),
            statics=dict(name=self.name, iters=iters),
        )

    def step(self, state, inp, aux, statics):
        return state, state
