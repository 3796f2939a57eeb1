"""Seconds from the benchmark's start (before torch is imported) to the
first timed step: imports, the kernels' build or load, weights, state
and the first steps that warm every shape."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(record):
    return record.setup_s
