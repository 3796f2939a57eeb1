"""BAD: a tensor value read on the host inside the step.

`.item()` copies the value to the host, so the host waits for the card
every iteration and the step loop stops queueing work ahead of it.
Branch on statics, or keep the value on the device with torch.where.
"""


class SyncKernel(MethodKernel):  # noqa: F821 — AST fixture, never imported
    name = "sync-fixture"

    def prepare(self, problem, net, cfg, iters):
        return Prepared(  # noqa: F821
            consts=(), steps=(), statics=dict(name=self.name, iters=iters)
        )

    def step(self, state, inp, aux, statics):
        x, k = state
        scale = 0.5 ** k.item()  # <-- host-sync-in-step
        return (x * scale, k + 1), x
