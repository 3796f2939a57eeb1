"""Device time a step of the granite family's Mamba-2 mixers, ms: the
device time under the benchmark's range around
`repro_torch.models.granite.ssm_mixer` (in-projection, convolution, K4's
forward kernel, gated norm and out-projection, on the forward pass and
again on remat's recompute) plus that of autograd's ``_SSDScanBackward``
nodes (K4's backward kernel), over the profiled steps. The other
operations' gradients are not in it. None when the trace saw no call."""

from portbench.trace import OP_PREFIX

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "model step", "step_s"
INSTRUMENT = (("repro_torch.models.granite", "ssm_mixer"),)


def read(record):
    t = record.trace
    if t is None or not t.calls.get("ssm_mixer"):
        return None
    us = t.ranges.get(OP_PREFIX + "ssm_mixer", 0.0) + t.ranges.get("_SSDScanBackward", 0.0)
    return us * 1e-3 / t.n_steps
