"""csI-ADMM consensus training (`repro_torch.distributed.consensus`), as
`repro_torch.launch.train --mode consensus` runs it.

The timed call is the user's loop body: the host batch and alive mask
from the generator, the batch to the device, ``ConsensusRuntime.
train_step``, the loss read back. The first step's gradient is read as
the update reads it, from each parameter's ``.grad`` once autograd has
accumulated it (a post-accumulate hook that takes its float32 norm):
with weights stored in bfloat16, the state after one step holds that
gradient only to rounding, since a step of g / (rho + tau) is far under
one bf16 unit of most weights. The served model is z.

The code is the mix's (``code_seed``: the launcher's default seed 0), not
the run's: the randomized cyclic code's conditioning varies with the seed
it is drawn from (row weights up to 262 times the uncoded 1/(K P) for
some), and bfloat16 gradients summed under such cancelling weights carry
that much more round-off, so a code drawn per run would change the work
from seed to seed.

A mix with ``cards`` C above 1 places agent a on card a % C
(``ConsensusRuntime(devices=...)``): one replica of the model and one copy
of z on each card, and each committing agent's z-delta copied to every
card. The model, z and the served readings stay on the first card. On the
CPU the C devices are the one CPU, listed C times. Without the key every
agent runs on the one device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from portbench import training
from portbench.training import compare, warm_up
from portbench.reference import coding, updates
from portbench.traffic import generator

__all__ = ["Program", "agent_devices", "reference", "tokens", "warm_up", "compare"]


class Program:
    def __init__(self, cell, seed: int, device):
        from repro_torch.distributed import ConsensusConfig, ConsensusRuntime

        t = cell.traffic
        self.model = training.port_model(cell, seed, device)
        self.rt = ConsensusRuntime(self.model, ConsensusConfig(
            n_agents=t["agents"], K=t["ecns"], S=t["stragglers"], scheme=t["scheme"],
            rho=t["rho"], c_tau=t["c_tau"], c_gamma=t["c_gamma"], mode=t["mode"],
            seed=t["code_seed"]), devices=agent_devices(t, device))
        self.state = self.rt.init_state()
        self.feed = generator.feed(t, cell.config["model"]["vocab"], seed)
        self.device = torch.device(device)
        self._order = training.leaf_order(cell)
        self._hooks, self._grad = [], {}

    def step(self) -> float:
        with record_function("portbench.batch"):
            batch, alive = next(self.feed)
        with record_function("portbench.to_device"):
            tb = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        with record_function("portbench.train_step"):
            self.state, metrics = self.rt.train_step(self.state, tb, alive)
        with record_function("portbench.read_loss"):
            return float(metrics["loss"])

    def watch_gradient(self) -> None:
        for n, p in self.model.named_parameters():
            def hook(p, n=n):
                g = p.grad.float()
                self._grad[n] = (torch.linalg.vector_norm(g),
                                 training.projections(g, self._order[n]))
            self._hooks.append(p.register_post_accumulate_grad_hook(hook))

    def first_gradient(self):
        for h in self._hooks:
            h.remove()
        zero = (torch.zeros((), device=self.device),
                torch.zeros(training.PROJECTIONS, device=self.device))
        got = {n: self._grad.get(n, zero) for n, _ in self.model.named_parameters()}
        self._hooks, self._grad = [], {}
        names = list(got)
        norm = torch.stack([got[n][0] for n in names]).cpu().tolist()
        proj = torch.stack([got[n][1] for n in names]).cpu().tolist()
        return dict(zip(names, norm)), dict(zip(names, proj))

    def served(self) -> Dict[str, torch.Tensor]:
        return self.state["z"]

    def close(self) -> None:
        del self.state, self.rt, self.model


def agent_devices(traffic: dict, device):
    """The devices the agents are placed on: None (the model's one device)
    for a mix without ``cards`` above 1; else card 0 to cards - 1, or on
    the CPU the one CPU listed ``cards`` times."""
    cards = traffic.get("cards", 1)
    if cards == 1:
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", c) for c in range(cards)]
    return [dev] * cards


def tokens(traffic: dict) -> dict:
    """Distinct tokens a step trains (forward and backward) and runs
    forward only: a partition repeated on S + 1 ECNs counts once."""
    A, K, P, S = traffic["agents"], traffic["ecns"], traffic["rows_per_partition"], traffic["seq"]
    committing = 1 if traffic["mode"] == "incremental" else A
    return {"trained_rows": committing * K * P, "forward_rows": (A - committing) * K * P,
            "seq": S}


def _rows(batch: dict, weights: np.ndarray, a: int, fault, device):
    R = weights.shape[1]
    tok = torch.from_numpy(batch["tokens"][a * R:(a + 1) * R])
    lab = torch.from_numpy(batch["labels"][a * R:(a + 1) * R])
    w = torch.from_numpy(weights[a])
    if fault == "half_batch":  # the first half of the rows, weights renormalised
        h = R // 2
        tok, lab, w = tok[:h], lab[:h], w[:h] * (w.sum() / w[:h].sum())
    return tok.to(device), lab.to(device), w.to(device=device, dtype=torch.float32)


def reference(cell, seed: int, device, precision: str = "float32", fault=None
              ) -> training.Readings:
    """The same steps in float32, state stored as the configuration says."""
    t, m, fam = cell.traffic, cell.config["model"], cell.family
    A, K, S, P = t["agents"], t["ecns"], t["stragglers"], t["rows_per_partition"]
    rho = t["rho"]
    B = coding.cyclic_B(K, S, t["code_seed"])
    z = training.reference_weights(cell, seed, device)
    x = [{n: w.clone() for n, w in z.items()} for _ in range(A)]
    y = [{n: torch.zeros_like(w) for n, w in z.items()} for _ in range(A)]
    feed = generator.feed(t, m["vocab"], seed)
    losses, grad = [], None
    for k in range(1, t["checked_steps"] + 1):
        batch, alive = next(feed)
        weights = coding.row_weights(B, alive, S, P)
        tau, gamma = updates.admm_schedule(k, t["c_tau"], t["c_gamma"])
        commit = {(k - 1) % A} if t["mode"] == "incremental" else set(range(A))
        zacc = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                for n, w in z.items()}
        agent_losses = []
        for a in range(A):
            tok, lab, w = _rows(batch, weights, a, fault, device)
            p32 = {n: v.to(torch.float32, copy=True).requires_grad_(a in commit)
                   for n, v in x[a].items()}
            with torch.set_grad_enabled(a in commit):
                total, _ = fam.loss(p32, tok, lab, w, m, precision)
            agent_losses.append(float(total.detach()))
            if a in commit:
                total.backward()
                g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for n, p in p32.items()}
                if grad is None:
                    grad = training.gradient_readings(g, training.leaf_order(cell))
                updates.admm_agent_update(x[a], y[a], z, g, zacc, tau, gamma, rho)
                del g
            del p32, total
        updates.admm_z_update(z, zacc, A)
        del zacc
        losses.append(float(np.mean(agent_losses)))
    del x, y
    change = training.change_norms(z, cell, seed)
    return training.Readings(losses, grad[0], change, grad[1])
