"""Device time a step of the granite family's attention mixers, ms: the
device time under the benchmark's range around
`repro_torch.models.granite.attn_mixer` (the q, k, v and out projections
and K3's forward kernel, on the forward pass and again on remat's
recompute) plus that of autograd's ``_FlashAttentionBackward`` nodes (K3's
backward kernel), over the profiled steps. The projections' gradients are
not in it. None when the trace saw no call."""

from portbench.trace import OP_PREFIX

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "model step", "step_s"
INSTRUMENT = (("repro_torch.models.granite", "attn_mixer"),)


def read(record):
    t = record.trace
    if t is None or not t.calls.get("attn_mixer"):
        return None
    us = t.ranges.get(OP_PREFIX + "attn_mixer", 0.0) + t.ranges.get("_FlashAttentionBackward", 0.0)
    return us * 1e-3 / t.n_steps
