"""What the training mixes share: the port's model from a configuration
file and the benchmark's weights, set-up's first steps and the program's
readings from them, and the comparison that decides ``correct``.

Set-up drives the one program object the window then times through its
first ``checked_steps`` steps, by the window's own call and feed. The
program's readings:

- ``loss``: each of those steps' loss, as the step returns it;
- ``grad``: each leaf's norm of the first step's gradient as the update
  gets it (the runtime says how it reads it);
- ``change``: each leaf's norm of (weights after the last checked step -
  the seed's weights), of the model the runtime serves.

The reference follows the same steps from the same seed in float32 and
gives the same readings. The numbers compared:

- ``loss``: the largest |program - reference| / |reference| over the steps;
- ``grad``: over the leaves, the largest |program's norm - reference's| /
  max(reference's norm of that leaf, of the median leaf);
- ``change``: the same over the leaves' change, leaving out each leaf
  whose reference gradient is under a thousandth of the median leaf's
  (such a leaf moves by round-off alone);
- ``grad_median``, ``change_median``: the median leaf's gap of the same,
  steadier where one leaf's gap swings (an MoE router's, under route
  flips);
- ``grad_proj``, ``grad_proj_median``: the worst and the median leaf's
  root-mean-square gap between the program's and the reference's
  projections of the first gradient on ``PROJECTIONS`` fixed random
  directions, over the same floor. A gap of norms moves only to second
  order under random error (|g + e| - |g| ~ |e|^2 / 2|g|); a projection
  gap moves to first order (~ |e| / |g|), so it tells a lower precision
  from route flips where the norms cannot.

A cell's limits file says which of them it holds: a number with no
upper reading (neither the control nor a fault reads far enough above
the program) is reported beside no limit and not held.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.weights import load_into, make_weights

__all__ = ["Readings", "port_model", "warm_up", "norms", "change_norms", "compare",
           "reference_weights"]


@dataclasses.dataclass
class Readings:
    loss: List[float]
    grad: Dict[str, float]
    change: Dict[str, float]
    grad_proj: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    step_s: List[float] = dataclasses.field(default_factory=list)  # set-up's steps, host clock


PROJECTIONS = 4  # random directions a leaf's gradient is projected on
_PROJECTION_SEED = 2010_00914
_CHUNK = 1 << 20  # elements a draw: keeps the directions' memory far under the step's


@torch.no_grad()
def projections(g: torch.Tensor, index: int) -> torch.Tensor:
    """(PROJECTIONS,) float32: g's dot products with standard normal
    directions drawn from a fixed seed and the leaf's index, chunk by chunk
    on g's device (the same directions on both sides of a comparison)."""
    gen = torch.Generator(device=g.device).manual_seed(_PROJECTION_SEED + index)
    flat = g.reshape(-1)
    out = torch.zeros(PROJECTIONS, dtype=torch.float32, device=g.device)
    for start in range(0, flat.numel(), _CHUNK):
        part = flat[start:start + _CHUNK].float()
        r = torch.randn((PROJECTIONS, part.numel()), generator=gen, dtype=torch.float32,
                        device=g.device)
        out += r @ part
    return out


def gradient_readings(grads: Dict[str, torch.Tensor], order: Dict[str, int]):
    """(each leaf's norm, each leaf's projections), read in one transfer each."""
    proj = {n: projections(g, order[n]) for n, g in grads.items()}
    names = list(proj)
    vals = torch.stack([proj[n] for n in names]).cpu().tolist()
    return norms(grads), dict(zip(names, vals))


def leaf_order(cell) -> Dict[str, int]:
    return {n: i for i, n in enumerate(cell.family.param_spec(cell.config["model"]))}


def model_dtype(cell) -> torch.dtype:
    return getattr(torch, cell.config["model"]["dtype"])


def port_model(cell, seed: int, device):
    """The port's model of the configuration, holding the seed's weights."""
    from repro_torch.models.registry import empty_model
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig.from_dict({"name": cell.config["name"], **cell.config["model"]})
    model = empty_model(cfg, device)
    spec = cell.family.param_spec(cell.config["model"])
    w = make_weights(spec, model_dtype(cell), seed, device)
    load_into(model, w)
    del w
    return model


def reference_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = cell.family.param_spec(cell.config["model"])
    return make_weights(spec, model_dtype(cell), seed, device)


@torch.no_grad()
def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's float32 norm, read in one transfer."""
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, vals.cpu().tolist()))


@torch.no_grad()
def change_norms(now: Dict[str, torch.Tensor], cell, seed: int) -> Dict[str, float]:
    """Each leaf's norm of (now - the seed's weights)."""
    start = reference_weights(cell, seed, next(iter(now.values())).device)
    names = list(start)
    vals = torch.stack([torch.linalg.vector_norm(now[n].float() - start[n].float())
                        for n in names])
    return dict(zip(names, vals.cpu().tolist()))


def warm_up(program, cell, seed: int) -> Readings:
    """The first ``checked_steps`` steps of the program, through its timed
    call: they warm every shape the window uses, and give the readings."""
    losses, times = [], []

    def step():
        t = time.perf_counter()
        losses.append(program.step())
        times.append(time.perf_counter() - t)

    program.watch_gradient()
    step()
    grad, proj = program.first_gradient()
    for _ in range(cell.traffic["checked_steps"] - 1):
        step()
    change = change_norms(program.served(), cell, seed)
    return Readings(losses, grad, change, proj, times)


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> tuple:
    """(worst leaf's gap, where), (median leaf's gap, where)."""
    names = list(names)
    floor = float(np.median([ref[n] for n in names]))
    gaps = sorted((abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30), n) for n in names)
    bad = [(math.inf, n) for g, n in gaps if not math.isfinite(g)]  # NaN compares false
    if bad:
        return bad[0], bad[0]
    return gaps[-1], gaps[len(gaps) // 2]


def compare(prog: Readings, ref: Readings) -> Dict[str, tuple]:
    """name -> (number, where): the numbers compared."""
    if len(prog.loss) != len(ref.loss) or not all(map(math.isfinite, prog.loss)):
        loss = (math.inf, "losses")
    else:
        loss = max((abs(p - r) / abs(r), f"step {i + 1}")
                   for i, (p, r) in enumerate(zip(prog.loss, ref.loss)))
    grad, grad_median = _gaps(prog.grad, ref.grad, ref.grad)
    med = float(np.median(list(ref.grad.values())))
    moved = [n for n, g in ref.grad.items() if g >= 1e-3 * med]
    change, change_median = _gaps(prog.change, ref.change, moved)
    out = {"loss": loss, "grad": grad, "change": change, "grad_median": grad_median,
           "change_median": change_median}
    if prog.grad_proj and ref.grad_proj:
        proj = sorted(
            (math.sqrt(np.mean((np.asarray(prog.grad_proj[n]) - ref.grad_proj[n]) ** 2))
             / max(ref.grad[n], med, 1e-30), n) for n in ref.grad)
        bad = [(math.inf, n) for g, n in proj if not math.isfinite(g)]
        out["grad_proj"] = bad[0] if bad else proj[-1]
        out["grad_proj_median"] = bad[0] if bad else proj[len(proj) // 2]
    return out
