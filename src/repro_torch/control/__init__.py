"""Online control of the code/deadline frontier.

PyTorch port of `repro.control`. A bandit controller (UCB1/EXP3,
`repro_torch.control.bandit`) rides the step loop's carry of the
coded-ADMM family and selects one (code family, S, deadline) arm per run
and iteration from observed iteration wall-clock alone — the arm
schedules are host-side step data, so an adaptive group stays one step
loop (`repro_torch.control.kernel`, registered as method "a-csI-ADMM").
"""

from .bandit import (
    BANDIT_ALGOS,
    BanditPolicy,
    init_state,
    replay,
    schedule_inputs,
    select,
    update,
)
from .kernel import ADAPTIVE_KERNEL, AdaptiveADMM, AdaptiveRun, device_pulls

__all__ = [
    "BANDIT_ALGOS",
    "BanditPolicy",
    "schedule_inputs",
    "init_state",
    "select",
    "update",
    "replay",
    "AdaptiveRun",
    "AdaptiveADMM",
    "ADAPTIVE_KERNEL",
    "device_pulls",
]
