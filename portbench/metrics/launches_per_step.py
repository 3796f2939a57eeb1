"""Device kernels a step launches: the kernels the profiler records in
the traced window on every card (copies and fills not counted) over its
steps."""

UNIT, BETTER, SOURCE = "launches/step", "lower", "device_trace"
LAYER, MOVES = "step loop and host dispatch", "step_s"


def read(record):
    t = record.trace
    return t.kernel_launches() / t.n_steps if t and t.device else None
