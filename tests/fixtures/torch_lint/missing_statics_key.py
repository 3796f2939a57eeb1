"""BAD: step reads a statics key no host-side construction produces.

The statics dict is what runs of one batch share; a key consumed in
step but absent from every prepare/_statics is a latent KeyError and a
hole in the static signature.
"""


class ForgetfulKernel(MethodKernel):  # noqa: F821 — AST fixture, never imported
    name = "forgetful-fixture"

    def prepare(self, problem, net, cfg, iters):
        return Prepared(  # noqa: F821
            consts=(), steps=(), statics=dict(name=self.name, iters=iters)
        )

    def step(self, state, inp, aux, statics):
        gain = statics["ghost_gain"]  # <-- statics-key-not-in-signature
        return state * gain, state
