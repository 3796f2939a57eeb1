"""Model FLOP utilisation of a training step, percent: the model's FLOPs
a step needs over (the step's time in the traced run's unprofiled window
x the cell's chips x one chip's peak for products of the configuration's
dtype).

FLOPs: 6 N per distinct token trained (forward and backward) and 2 N per
distinct token run forward only, N being the parameters that multiply a
token (the family's ``active_params``: the head included, k of E experts);
plus attention's score and value products (``attention_flops``, three
times for a trained row). A partition repeated on S + 1 ECNs counts once;
recomputation for remat is not counted."""

import torch

from portbench.work.roofline import PEAK_PRODUCT_FLOPS

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model step", "step_s"


def step_flops(cell) -> float:
    m, fam = cell.config["model"], cell.family
    tok = cell.runtime.tokens(cell.traffic)
    n, seq = fam.active_params(m), tok["seq"]
    attn = fam.attention_flops(m, seq)
    return (6 * n * seq * tok["trained_rows"] + 2 * n * seq * tok["forward_rows"]
            + 3 * attn * tok["trained_rows"] + attn * tok["forward_rows"])


def read(record):
    if not record.steps or record.trace is None:
        return None
    peak = PEAK_PRODUCT_FLOPS[getattr(torch, record.cell.config["model"]["dtype"])]
    chips = record.cell.entry["chips"]
    return 100.0 * step_flops(record.cell) / (record.window_s / record.steps * peak * chips)
