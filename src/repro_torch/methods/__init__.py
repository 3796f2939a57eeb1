"""Method kernels: one step function per algorithm, over a runs axis.

PyTorch port of `repro.methods`. Each method is a `MethodKernel` —
host-side ``prepare`` plus device-side ``setup``/``init``/``step``/
``final`` — and `repro_torch.methods.driver` derives ``run_serial`` and
``run_batch`` from it. Importing this package populates the `KERNELS`
registry with what is ported:

  sI-ADMM / csI-ADMM / I-ADMM  (paper Algorithms 1 & 2, eq. 4)

The baselines, the privacy/compression variants, streaming reductions,
the async mode, the bandit controller and the sharded tier come in later
slices (ROADMAP Queue 1, items 8-13).
"""

from .admm import ADMMRun, IncrementalADMM
from .base import (
    KERNELS,
    MethodKernel,
    Prepared,
    get_kernel,
    prepared_to_device,
    register,
    resolve_device,
)
from .driver import run_batch, run_serial, run_sharded, run_steps

__all__ = [
    "MethodKernel",
    "Prepared",
    "KERNELS",
    "register",
    "get_kernel",
    "resolve_device",
    "prepared_to_device",
    "run_serial",
    "run_batch",
    "run_sharded",
    "run_steps",
    "ADMMRun",
    "IncrementalADMM",
]
