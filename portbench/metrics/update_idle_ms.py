"""Device idle time a step while the host is in the work around the
model: the part of the device's idle set (the gaps in the union of every
device operation over the traced window) that falls inside the program's
update spans (``consensus.row_weights``, ``.load``, ``.update``,
``.z_update``; ``plain.clip``, ``.adam``; `portbench.phases.idle_in`), in
ms over the profiled steps. None when the program marks no such span."""

from portbench import phases

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "update", "step_s"


def read(record):
    t = record.trace
    spans = phases.intervals(t.host, phases.UPDATE) if t and t.device else []
    return phases.idle_in(t.device, spans, *t.window) * 1e-3 / t.n_steps if spans else None
