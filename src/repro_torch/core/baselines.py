"""State-of-the-art baselines the paper compares against (§V-A).

PyTorch port of `repro.core.baselines`:

  1) W-ADMM  [3]  — random-walk incremental ADMM (Walkman): same incremental
                    updates as sI-ADMM but the token performs a uniform random
                    walk over neighbors (one agent + one link per iteration).
  2) D-ADMM  [14]/[9] — gossip-style decentralized consensus ADMM: every agent
                    updates every iteration using all its neighbors (2|E|
                    directed messages per iteration).
  3) DGD     [6]  — decentralized gradient descent with Metropolis mixing and
                    diminishing step size.
  4) EXTRA   [7]  — exact first-order gossip method with constant step size.

All baselines run on the same `LeastSquaresProblem` and report the same
metrics as `repro_torch.core.admm` (accuracy eq. 23, test error,
cumulative communication units). These are thin serial entry points over
the method kernels (`repro_torch.methods.walkman`,
`repro_torch.methods.gossip`); ``device_kw`` (``device``, ``dtype``) go
to `repro_torch.methods.run_serial`, whose default device is the card.
"""

from __future__ import annotations

from .admm import ADMMConfig, Trace
from .graph import Network
from .problems import LeastSquaresProblem

__all__ = [
    "run_wadmm",
    "run_dadmm",
    "run_dgd",
    "run_extra",
]


def run_wadmm(
    problem: LeastSquaresProblem,
    net: Network,
    cfg: ADMMConfig,
    iters: int,
    **device_kw,
) -> Trace:
    """Walkman with the same stochastic proximal-linearized x-update."""
    from repro_torch.methods import ADMMRun, get_kernel, run_serial

    return run_serial(
        get_kernel("W-ADMM"), problem, net, ADMMRun(cfg), iters, **device_kw
    )


def run_dadmm(
    problem: LeastSquaresProblem,
    net: Network,
    rho: float,
    iters: int,
    **device_kw,
) -> Trace:
    from repro_torch.methods import GossipRun, get_kernel, run_serial

    return run_serial(
        get_kernel("D-ADMM"), problem, net, GossipRun(rho), iters, **device_kw
    )


def run_dgd(
    problem: LeastSquaresProblem,
    net: Network,
    alpha0: float,
    iters: int,
    diminishing: bool = True,
    **device_kw,
) -> Trace:
    from repro_torch.methods import GossipRun, get_kernel, run_serial

    return run_serial(
        get_kernel("DGD"), problem, net,
        GossipRun(alpha0, diminishing=diminishing), iters, **device_kw,
    )


def run_extra(
    problem: LeastSquaresProblem,
    net: Network,
    alpha: float,
    iters: int,
    **device_kw,
) -> Trace:
    from repro_torch.methods import GossipRun, get_kernel, run_serial

    return run_serial(
        get_kernel("EXTRA"), problem, net, GossipRun(alpha), iters, **device_kw
    )
