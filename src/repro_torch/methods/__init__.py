"""Method kernels: one step function per algorithm, over a runs axis.

PyTorch port of `repro.methods`. Each method is a `MethodKernel` —
host-side ``prepare`` plus device-side ``setup``/``init``/``step``/
``final`` — and `repro_torch.methods.driver` derives ``run_serial``,
``run_batch`` and ``run_sharded`` from it, each with or without a
streaming `Reduction`. Importing this package populates the `KERNELS`
registry with all of `repro`'s methods:

  sI-ADMM / csI-ADMM / I-ADMM  (paper Algorithms 1 & 2, eq. 4)
  W-ADMM, D-ADMM, DGD, EXTRA   (paper §V-A baselines)
  pI-ADMM                      (privacy-perturbed, arXiv 2003.10615)
  cq-sI-ADMM                   (compressed token, arXiv 2501.13516)
  a-csI-ADMM                   (bandit-controlled frontier, `repro_torch.control`)
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
from .compression import CompressionRun
from .driver import run_batch, run_serial, run_sharded, run_steps
from .gossip import DADMM, DGD, EXTRA, GossipRun
from .privacy import PrivacyRun
from .reductions import METRIC_FIELDS, Reduction, reduce_trace
from .walkman import WalkmanADMM

# The adaptive controller kernel lives in `repro_torch.control` (it
# layers on top of the ADMM family) but registers in the same table: a
# plain module import, last, so `.admm` is complete, and attribute-free,
# so a controller-first import order cannot deadlock this package.
import repro_torch.control.kernel  # noqa: E402,F401

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
    "Reduction",
    "reduce_trace",
    "METRIC_FIELDS",
    "ADMMRun",
    "GossipRun",
    "PrivacyRun",
    "CompressionRun",
    "IncrementalADMM",
    "WalkmanADMM",
    "DADMM",
    "DGD",
    "EXTRA",
]
