"""Method kernels: one step function per algorithm, over a runs axis.

PyTorch port of `repro.methods`. Each method is a `MethodKernel` —
host-side ``prepare`` plus device-side ``setup``/``init``/``step``/
``final`` — and `repro_torch.methods.driver` derives ``run_serial`` and
``run_batch`` from it. Importing this package populates the `KERNELS`
registry with what is ported:

  sI-ADMM / csI-ADMM / I-ADMM  (paper Algorithms 1 & 2, eq. 4)
  W-ADMM, D-ADMM, DGD, EXTRA   (paper §V-A baselines)
  pI-ADMM                      (privacy-perturbed, arXiv 2003.10615)
  cq-sI-ADMM                   (compressed token, arXiv 2501.13516)

Streaming reductions, the async mode, the bandit controller (a-csI-ADMM)
and the sharded tier come in later slices (ROADMAP Queue 1, items 10-13).
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
from .walkman import WalkmanADMM

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
    "GossipRun",
    "PrivacyRun",
    "CompressionRun",
    "IncrementalADMM",
    "WalkmanADMM",
    "DADMM",
    "DGD",
    "EXTRA",
]
