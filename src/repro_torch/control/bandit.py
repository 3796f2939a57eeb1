"""UCB1 / EXP3 bandit policies as loop-carry algebra over a runs axis.

PyTorch port of `repro.control.bandit`. The online controller of
`repro_torch.control.kernel` selects a (code family, S, deadline) arm
every iteration inside the driver's step loop, for every run at once:

- **State is a fixed set of tensors** ``{n: (R, A), s: (R, A)}`` in the
  loop carry: per-arm pull counts and per-arm score (reward sums for
  UCB1, log-weights for EXP3). No Python control flow depends on it, so
  the loop never synchronises with the device.
- **Everything random or transcendental in the iteration index is
  computed host-side** as per-step data: EXP3's sampling uniforms ``u``
  (seed stream ``[8, seed]``) and UCB1's ``log k`` sequence, both
  (iters,) arrays, copied from the reference. UCB1's recursion is then
  built from correctly rounded IEEE operations (div, sqrt, mul, add,
  argmax — which takes the first of equal values on every device), so
  the device's pulls equal the numpy twin's.
- **EXP3's sums run arm by arm, left to right** (`_seq_sum`,
  `_seq_cumsum`): numpy's sum of fewer than 8 values and its cumsum are
  sequential, while ``torch.sum``/``torch.cumsum`` may associate
  otherwise (vector lanes on the CPU, trees or scans on a card). Only
  ``exp`` then differs from numpy, by at most an ulp or so, which flips
  an arm only where the inverse-CDF draw falls within that of a boundary.
- **The host twin** (:func:`replay`) runs the SAME recursion in numpy
  over the same tables, copied from the reference. ``prepare`` uses it to
  realize the pull-dependent simulated clock and the async schedules
  before the device runs.

Both policies maximize cumulative reward in [0, 1]; the controller feeds
them the negative-wall-clock reward surface of
:meth:`repro_torch.core.timing.TimingModel.reward`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "BANDIT_ALGOS",
    "BanditPolicy",
    "schedule_inputs",
    "init_state",
    "select",
    "update",
    "replay",
]

BANDIT_ALGOS = ("ucb1", "exp3")

# Seed stream of the controller's sampling uniforms (the host seed-stream
# registry: [2]=privacy, [4..6]=timing, [7]=staleness).
UNIFORM_STREAM = 8


@dataclasses.dataclass(frozen=True)
class BanditPolicy:
    """One controller policy: algorithm + its (runtime) hyper-parameters.

    ``c`` is UCB1's confidence-width multiplier; ``eta`` EXP3's learning
    rate and ``gamma`` its uniform-exploration mixture. All three ride
    the device as runtime constants (one (3,) array per run); only
    ``algo`` is a static.
    """

    algo: str = "ucb1"
    c: float = 0.5
    eta: float = 0.1
    gamma: float = 0.1

    def __post_init__(self) -> None:
        if self.algo not in BANDIT_ALGOS:
            raise ValueError(
                f"unknown bandit algorithm {self.algo!r}; "
                f"known: {BANDIT_ALGOS}"
            )
        if self.c < 0 or self.eta < 0:
            raise ValueError(
                f"bandit c/eta must be >= 0, got ({self.c}, {self.eta})"
            )
        if not 0 < self.gamma <= 1:
            raise ValueError(
                f"exp3 gamma must be in (0, 1], got {self.gamma}"
            )

    @property
    def params(self) -> np.ndarray:
        """The (3,) runtime-constant parameter vector [c, eta, gamma]."""
        return np.array([self.c, self.eta, self.gamma])


def schedule_inputs(iters: int, seed: int) -> "tuple":
    """(u, logk) per-step controller inputs, computed host-side.

    ``u``: EXP3 sampling uniforms, seed stream ``[UNIFORM_STREAM, seed]``
    (drawn even for UCB1 so switching ``algo`` perturbs nothing else).
    ``logk``: log(1), log(2), ... — UCB1's confidence numerator, so the
    device recursion never calls a transcendental.
    """
    rng = np.random.default_rng([UNIFORM_STREAM, seed])
    u = rng.random(iters)
    logk = np.log(np.arange(1, iters + 1, dtype=float))
    return u, logk


# -- device side (torch over R): one select/update per loop step -----------


def init_state(R: int, n_arms: int, dtype, device) -> dict:
    """Zeroed controller carry: per-arm pull counts and scores."""
    kw = dict(dtype=dtype, device=device)
    return dict(
        n=torch.zeros((R, n_arms), **kw), s=torch.zeros((R, n_arms), **kw)
    )


def _seq_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the arm axis, left to right (numpy's order)."""
    cols = [a[:, 0]]
    for j in range(1, a.shape[1]):
        cols.append(cols[-1] + a[:, j])
    return torch.stack(cols, dim=1)


def _seq_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the arm axis, left to right, as (R, 1)."""
    acc = a[:, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j]
    return acc[:, None]


def _exp3_probs(s, par, n_arms: int):
    """EXP3 arm distribution: gamma-mixed softmax of the log-weights."""
    e = torch.exp(s - s.amax(dim=1, keepdim=True))
    w = e / _seq_sum(e)
    g = par[:, 2:3]
    return (1.0 - g) * w + g / n_arms


def select(algo: str, state, u, logk, par, n_arms: int) -> torch.Tensor:
    """This iteration's arm of every run, (R,) int64, from the carry.

    ``u`` and ``logk`` are (R,), ``par`` (R, 3)."""
    n, s = state["n"], state["s"]
    if algo == "ucb1":
        k = n.sum(dim=1)  # integer counts: exact in any order
        nf = n.clamp_min(1.0)
        idx = s / nf + par[:, 0:1] * torch.sqrt(logk[:, None] / nf)
        arm = torch.argmax(idx, dim=1)
        # Initialization round-robin: pull each arm once before trusting
        # the confidence index.
        return torch.where(k < n_arms, k.to(torch.int64), arm)
    # exp3: invert the mixed-softmax CDF at the host-drawn uniform.
    cdf = _seq_cumsum(_exp3_probs(s, par, n_arms))
    return (cdf < u[:, None]).sum(dim=1).clamp_max(n_arms - 1)


def update(algo: str, state, arm, reward, par, n_arms: int) -> dict:
    """Fold each run's pulled arm's observed reward, (R,), into the
    carry."""
    runs = torch.arange(arm.shape[0], device=arm.device)
    n = state["n"].clone()
    n[runs, arm] += 1.0
    s = state["s"].clone()
    if algo == "ucb1":
        s[runs, arm] += reward
    else:
        # Importance-weighted reward estimate on the sampled arm.
        p = _exp3_probs(state["s"], par, n_arms)
        s[runs, arm] += par[:, 1] * reward / p[runs, arm]
    return dict(state, n=n, s=s)


# -- host twin (numpy): the same recursion, sequentially -------------------


def replay(
    policy: BanditPolicy, rewards: np.ndarray, u: np.ndarray,
    logk: np.ndarray,
) -> np.ndarray:
    """Pull sequence of the device controller, computed host-side.

    ``rewards`` is the (iters, n_arms) pre-tabulated reward table, ``u``
    and ``logk`` the :func:`schedule_inputs` arrays. Mirrors
    :func:`select`/:func:`update` operation for operation (same maximum
    conventions, same summation order), so the returned (iters,) int32
    pulls match the device trajectory.
    """
    iters, n_arms = rewards.shape
    n = np.zeros(n_arms)
    s = np.zeros(n_arms)
    pulls = np.zeros(iters, dtype=np.int32)
    for t in range(iters):
        if policy.algo == "ucb1":
            k = n.sum()
            if k < n_arms:
                arm = int(k)
            else:
                nf = np.maximum(n, 1.0)
                arm = int(np.argmax(s / nf + policy.c * np.sqrt(logk[t] / nf)))
        else:
            e = np.exp(s - np.max(s))
            w = e / np.sum(e)
            p = (1.0 - policy.gamma) * w + policy.gamma / n_arms
            arm = min(int(np.sum(np.cumsum(p) < u[t])), n_arms - 1)
        r = rewards[t, arm]
        n[arm] += 1.0
        if policy.algo == "ucb1":
            s[arm] += r
        else:
            s[arm] += policy.eta * r / p[arm]
        pulls[t] = arm
    return pulls
