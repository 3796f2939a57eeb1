"""Plain training (`repro_torch.distributed.plain.PlainRuntime`): the
loss's gradient, clipping at a global norm, one Adam step, as
`repro_torch.launch.train --mode plain` runs it.

The timed call is the user's loop body: the host batch from the
generator, the batch to the device, ``PlainRuntime.train_step``, the
loss read back. The first step's gradient as Adam gets it (after
clipping) is worked out from the optimizer's state after that step: m =
(1 - b1) g. The served model is the model's own weights.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from portbench import training
from portbench.training import compare, warm_up
from portbench.reference import updates
from portbench.traffic import generator

__all__ = ["Program", "reference", "tokens", "warm_up", "compare"]

_B1 = 0.9  # PlainRuntime's Adam


class Program:
    def __init__(self, cell, seed: int, device):
        from repro_torch.distributed import PlainRuntime

        self.model = training.port_model(cell, seed, device)
        self.rt = PlainRuntime(self.model, lr=cell.traffic["lr"])
        self.state = self.rt.init_state()
        self.feed = generator.feed(cell.traffic, cell.config["model"]["vocab"], seed)
        self.device = torch.device(device)
        self._order = training.leaf_order(cell)

    def step(self) -> float:
        with record_function("portbench.batch"):
            batch, _ = next(self.feed)
        with record_function("portbench.to_device"):
            tb = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        with record_function("portbench.train_step"):
            self.state, metrics = self.rt.train_step(self.state, tb)
        with record_function("portbench.read_loss"):
            return float(metrics["loss"])

    def watch_gradient(self) -> None:
        pass

    def first_gradient(self):
        return training.gradient_readings(
            {n: m / (1 - _B1) for n, m in self.state["opt"]["m"].items()}, self._order)

    def served(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def close(self) -> None:
        del self.state, self.rt, self.model


def tokens(traffic: dict) -> dict:
    return {"trained_rows": traffic["rows"], "forward_rows": 0, "seq": traffic["seq"]}


def reference(cell, seed: int, device, precision: str = "float32", fault=None
              ) -> training.Readings:
    """The same steps in float32, weights stored as the configuration says."""
    t, m, fam = cell.traffic, cell.config["model"], cell.family
    p = training.reference_weights(cell, seed, device)
    mom = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device) for n, w in p.items()}
    vel = {n: torch.zeros_like(v) for n, v in mom.items()}
    feed = generator.feed(t, m["vocab"], seed)
    losses, grad = [], None
    for k in range(1, t["checked_steps"] + 1):
        batch, _ = next(feed)
        rows = t["rows"] // 2 if fault == "half_batch" else t["rows"]
        tok = torch.from_numpy(batch["tokens"][:rows]).to(device)
        lab = torch.from_numpy(batch["labels"][:rows]).to(device)
        w = torch.full((rows,), 1.0 / rows, dtype=torch.float32, device=device)
        p32 = {n: v.to(torch.float32, copy=True).requires_grad_() for n, v in p.items()}
        total, _ = fam.loss(p32, tok, lab, w, m, precision)
        total.backward()
        g = {n: (q.grad if q.grad is not None else torch.zeros_like(q)) for n, q in p32.items()}
        del p32
        updates.clip_(g, t["clip"])
        if grad is None:
            grad = training.gradient_readings(g, training.leaf_order(cell))
        updates.adam_(p, g, mom, vel, k, t["lr"])
        losses.append(float(total.detach()))
        del g, total
    del mom, vel
    change = training.change_norms(p, cell, seed)
    return training.Readings(losses, grad[0], change, grad[1])
