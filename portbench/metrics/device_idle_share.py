"""Percent of the traced window in which no operation ran on a card:
1 - (the union of the card's device operations' intervals, kernels and
copies) / (the window's span), over the profiled steps, the mean over the
cell's cards (`portbench.trace.Trace.busy_s`)."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "step_s"


def read(record):
    t = record.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t and t.device else None
