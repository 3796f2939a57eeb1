"""CUDA runtime calls a step that block the host on the device
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, synchronous ``cudaMemcpy``) that start inside
the program's ``*.step`` span, over the profiled steps. Counted among the
window thread's host ranges, which are what the trace keeps: a sync on
autograd's device thread is not seen. None when the program marks no
step span."""

from portbench import phases

UNIT, BETTER, SOURCE = "syncs/step", "lower", "device_trace"
LAYER, MOVES = "step loop and host dispatch", "step_s"


def read(record):
    t = record.trace
    spans = phases.intervals(t.host, phases.STEP) if t and t.device else []
    return phases.syncs_in(t.host, spans) / t.n_steps if spans else None
