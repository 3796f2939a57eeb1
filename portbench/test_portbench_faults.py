"""The check that decides ``correct`` fails what it has to fail, on the
CPU at a small size.

- Each fault a training cell can have, planted in the program under a
  whole run (set-up, window, check, with the cell's own limits): a step
  that returns its state unchanged, half of each step's rows left out
  with the mean taken over the rest, and on a cell of several cards the
  exchange between them left out (`calibrate.no_exchange`). ``correct``
  has to come out false. (Training produces no tokens to alter.)
- The control, the reference computed with fp8 products put in the
  program's place, in the configuration's bfloat16: on one of the
  numbers compared it has to read at least three times what the program
  reads on any of the seeds tried, the separation the limits are set in
  (its readings at the cells' own size are in PERF.md).
"""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, harness, smoke
from portbench.test_portbench_harness import HELD, WITH_DEFERRED

MULTI_CARD = [c for c in HELD if harness.resolve(c, WITH_DEFERRED).traffic.get("cards", 1) > 1]


def _unchanged(program):
    """The step computes its loss and returns the state it was given."""
    rt = program.rt

    def step(state, batch, *rest):
        with torch.no_grad():
            loss, metrics = program.model.loss(
                {k: v for k, v in batch.items() if k in ("tokens", "labels")})
        return state, {"loss": loss, "nll": metrics["nll"]}

    rt.train_step = step


def _half_batch(program):
    """Each loss sees the first half of its rows, the mean over those."""
    loss = program.model.loss

    def half(batch):
        h = batch["tokens"].shape[0] // 2
        out = {k: v[:h] for k, v in batch.items()}
        if "loss_weights" in batch:
            w = batch["loss_weights"]
            out["loss_weights"] = w[:h] * (w.sum() / w[:h].sum())
        return loss(out)

    program.model.loss = half


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", HELD)
def test_planted_fault_comes_out_not_correct(cell, fault):
    c = smoke.smoke_cell(cell, spec=WITH_DEFERRED)
    result, checks = harness.run_cell(c, 2**31 + 17, 0.1, False, "cpu", 0.0,
                                      program_hook=fault)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", MULTI_CARD)
def test_exchange_left_out_comes_out_not_correct(cell):
    c = smoke.smoke_cell(cell, spec=WITH_DEFERRED)
    result, checks = harness.run_cell(c, 2**31 + 19, 0.1, False, "cpu", 0.0,
                                      program_hook=calibrate.no_exchange)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", HELD)
def test_control_reads_three_times_the_program(cell):
    c = smoke.smoke_cell(cell, dtype="bfloat16", spec=WITH_DEFERRED)
    rows = [calibrate.readings(c, seed, "cpu", control=seed == 11) for seed in (11, 12)]
    control = rows[0]["control"]
    held = c.limits  # the numbers the cell holds
    lower = {k: max(r["program"][k][0] for r in rows) for k in held}
    assert any(control[k][0] >= 3 * lower[k] for k in held), (lower, control)
