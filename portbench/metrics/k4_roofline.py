"""K4's share of its roofline, percent: the bound of the work of every
call of the SSD scan in the traced window (each call's forward, and the
backward of each call autograd differentiated, reckoned from the call's
shapes by `portbench.work.ssd_scan`) over the device time under the
benchmark's range around `repro_torch.kernels.ops.ssd_scan` plus the
``_SSDScanBackward`` node's. The same work whatever implements it."""

from portbench.trace import op_roofline
from portbench.work import ssd_scan as work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "step_s"
INSTRUMENT = (("repro_torch.kernels.ops", "ssd_scan"),)


def read(record):
    return op_roofline(record.trace, "ssd_scan", "_SSDScanBackward", work)
