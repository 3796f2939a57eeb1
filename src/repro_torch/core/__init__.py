"""The paper's primary contribution, ported: (coded) stochastic incremental
ADMM's host side.

Pure-numpy copies of `repro.core`'s graph, problem, coding, timing and
schedule modules, so every seed stream, code and schedule is bit-for-bit
the reference's, and the serial entry points of the paper's method and
of its §V-A baselines (`baselines.py`: W-ADMM, D-ADMM, DGD, EXTRA).
"""

from .admm import ADMMConfig, Trace, make_schedule, run_incremental_admm
from .baselines import run_dadmm, run_dgd, run_extra, run_wadmm
from .coding import (
    CODE_FAMILIES,
    GradientCode,
    check_arm_set,
    make_arm_set,
    make_code,
    paper_fig2_code,
)
from .graph import Network, make_network, metropolis_weights
from .problems import (
    DATASETS,
    Dataset,
    LeastSquaresProblem,
    allocate,
    make_ijcnn1_standin,
    make_synthetic,
    make_usps_standin,
)
from .timing import StragglerModel, TimingModel, sample_times

__all__ = [
    "ADMMConfig",
    "Trace",
    "make_schedule",
    "run_incremental_admm",
    "run_wadmm",
    "run_dadmm",
    "run_dgd",
    "run_extra",
    "CODE_FAMILIES",
    "GradientCode",
    "check_arm_set",
    "make_arm_set",
    "make_code",
    "paper_fig2_code",
    "Network",
    "make_network",
    "metropolis_weights",
    "DATASETS",
    "Dataset",
    "LeastSquaresProblem",
    "allocate",
    "make_synthetic",
    "make_usps_standin",
    "make_ijcnn1_standin",
    "StragglerModel",
    "TimingModel",
    "sample_times",
]
