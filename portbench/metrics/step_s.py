"""Seconds a training step takes: the window's wall time, from before its
first step to the synchronize of every card after its last, over the
steps completed in it. One number over the whole window, never a median
of steps, so a stall in any step shows."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(record):
    return record.window_s / record.steps if record.steps else None
