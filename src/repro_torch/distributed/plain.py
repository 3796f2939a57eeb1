"""Plain training / serving steps on one device (port of
`repro.distributed.plain`, without its mesh and XLA lowering).

``train_step`` is the reference's: the loss's gradient, clipping at a
global norm of 1.0, one Adam step (float32 moments), and the metrics
``loss``, ``nll`` and ``grad_norm``. The parameters live in the model and
are updated in place, as are the gradients' clipping and the optimizer's
moments in the runtime's state (``clip_by_global_norm_``,
``adam_update_``: the reference's arithmetic, leaf by leaf).

Under a recording profiler the step marks its phases
(`repro_torch.tracing.span`): ``plain.step`` around the call, and inside
it ``plain.forward``, ``plain.backward``, ``plain.clip``, ``plain.adam``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim import adam_init, adam_update_, clip_by_global_norm_
from repro_torch.tracing import span

__all__ = ["PlainRuntime"]


class PlainRuntime:
    """Train/prefill/decode steps for one model. Turns the model's
    parameters' gradients on (they are created without)."""

    def __init__(self, model, lr: float = 3e-4):
        self.model = model
        self.lr = lr
        model.requires_grad_(True)

    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def init_state(self) -> dict:
        return {"opt": adam_init(self.params())}

    def train_step(self, state: dict, batch: dict) -> Tuple[dict, dict]:
        with span("plain.step"):
            params = self.params()
            for p in params.values():
                p.grad = None
            with span("plain.forward"):
                loss, metrics = self.model.loss(batch)
            with span("plain.backward"):
                loss.backward()
            with span("plain.clip"):
                grads = {
                    k: torch.zeros_like(p) if p.grad is None else p.grad
                    for k, p in params.items()
                }
                gn = clip_by_global_norm_(grads, 1.0)
            with span("plain.adam"):
                adam_update_(params, grads, state["opt"], self.lr)
            del grads
            for p in params.values():
                p.grad = None
            return state, {
                "loss": loss.detach(),
                "nll": metrics["nll"].detach(),
                "grad_norm": gn,
            }

    def prefill_step(self, batch: dict) -> Tuple[torch.Tensor, Any]:
        kwargs = {}
        if "extra_embeds" in batch:
            kwargs["extra_embeds"] = batch["extra_embeds"]
        return self.model.prefill(batch["tokens"], **kwargs)

    def serve_step(self, cache: Any, token: torch.Tensor):
        return self.model.decode_step(cache, token)
