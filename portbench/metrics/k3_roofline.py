"""K3's share of its roofline, percent: the bound of the work of every
call of flash attention in the traced window (each call's forward, and
the backward of each call autograd differentiated, reckoned from the
call's shapes by `portbench.work.flash_attention`) over the device time
under the benchmark's range around `repro_torch.kernels.ops.
flash_attention` plus the ``_FlashAttentionBackward`` node's."""

from portbench.trace import op_roofline
from portbench.work import flash_attention as work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "step_s"
INSTRUMENT = (("repro_torch.kernels.ops", "flash_attention"),)


def read(record):
    return op_roofline(record.trace, "flash_attention", "_FlashAttentionBackward", work)
