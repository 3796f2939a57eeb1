"""Decentralized consensus problems and datasets — paper §V (eq. 24, Table I).

The paper evaluates decentralized least squares

    f_i(x_i; D_i) = 1/(2 b_i) * sum_j || x_i^T o_{i,j} - t_{i,j} ||^2 ,

with x in R^{p x d}, on one synthetic and two real datasets (USPS, ijcnn1).
The container is offline, so the real sets are replaced by *shape-and-scale
matched* synthetic stand-ins (same #samples, p, d, and a planted linear
model + noise); the synthetic dataset follows the paper exactly
(x_o, o_i ~ N(0, I), t_i = x_o^T o_i + e_i). This substitution is recorded
in DESIGN.md §6 — every claim we validate (convergence rate, communication
cost, straggler robustness) depends on the least-squares structure, not on
the specific images.

Data layout mirrors Algorithms 1 & 2: dataset D_i of agent i is divided into
K equal disjoint partitions xi_{i,j} (one per ECN); ECN j slices mini-batches
of size M/K (uncoded) or (S+1)*Mbar/K (coded, over its (S+1) assigned
partitions) with the paper's cyclic batch index I_{i,j}^k = m mod floor(...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Dataset",
    "LeastSquaresProblem",
    "make_synthetic",
    "make_usps_standin",
    "make_ijcnn1_standin",
    "DATASETS",
]


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A regression dataset: inputs O (n, p), targets T (n, d)."""

    name: str
    O_train: np.ndarray
    T_train: np.ndarray
    O_test: np.ndarray
    T_test: np.ndarray

    @property
    def p(self) -> int:
        return self.O_train.shape[1]

    @property
    def d(self) -> int:
        return self.T_train.shape[1]


def _planted(n_train: int, n_test: int, p: int, d: int, noise: float, seed: int, name: str) -> Dataset:
    rng = np.random.default_rng(seed)
    x_o = rng.standard_normal((p, d))
    O = rng.standard_normal((n_train + n_test, p))
    T = O @ x_o + noise * rng.standard_normal((n_train + n_test, d))
    return Dataset(
        name,
        O[:n_train],
        T[:n_train],
        O[n_train:],
        T[n_train:],
    )


def make_synthetic(seed: int = 0, noise: float = 0.1) -> Dataset:
    """Paper Table I synthetic: 50,400 train / 5,040 test, p=3, d=1."""
    return _planted(50_400, 5_040, 3, 1, noise, seed, "synthetic")


def make_usps_standin(seed: int = 1) -> Dataset:
    """USPS-shaped stand-in: 1,000 train / 100 test, p=64, d=10."""
    return _planted(1_000, 100, 64, 10, 0.3, seed, "usps")


def make_ijcnn1_standin(seed: int = 2) -> Dataset:
    """ijcnn1-shaped stand-in: 35,000 train / 3,500 test, p=22, d=2."""
    return _planted(35_000, 3_500, 22, 2, 0.2, seed, "ijcnn1")


DATASETS = {
    "synthetic": make_synthetic,
    "usps": make_usps_standin,
    "ijcnn1": make_ijcnn1_standin,
}


@dataclasses.dataclass(frozen=True)
class LeastSquaresProblem:
    """Consensus least squares over N agents (eq. 24).

    Arrays are stacked per agent with equal local sizes b (the paper allocates
    data "disjointly" across agents; we truncate to a multiple of N*K so all
    vectorized shapes are static).

      O: (N, b, p)   T: (N, b, d)
    """

    O: np.ndarray
    T: np.ndarray
    O_test: np.ndarray
    T_test: np.ndarray
    name: str = "lsq"

    @property
    def N(self) -> int:
        return self.O.shape[0]

    @property
    def b(self) -> int:
        return self.O.shape[1]

    @property
    def p(self) -> int:
        return self.O.shape[2]

    @property
    def d(self) -> int:
        return self.T.shape[2]

    # ---- oracles ---------------------------------------------------------

    def grad(self, i: int, x: np.ndarray, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """(Stochastic) gradient of f_i at x using the given sample rows."""
        O = self.O[i] if rows is None else self.O[i][rows]
        T = self.T[i] if rows is None else self.T[i][rows]
        return O.T @ (O @ x - T) / O.shape[0]

    def loss(self, i: int, x: np.ndarray) -> float:
        r = self.O[i] @ x - self.T[i]
        return float(0.5 * np.sum(r * r) / self.b)

    def global_loss(self, xs: np.ndarray) -> float:
        """Sum_i f_i(x_i) with per-agent iterates xs (N, p, d)."""
        return float(sum(self.loss(i, xs[i]) for i in range(self.N)))

    def test_error(self, x: np.ndarray) -> float:
        """Mean-square test error of a single (consensus) model x (p, d)."""
        r = self.O_test @ x - self.T_test
        return float(np.mean(np.sum(r * r, axis=-1)))

    def x_star(self) -> np.ndarray:
        """Closed-form global optimum of sum_i f_i (eq. 1)."""
        p, d = self.p, self.d
        H = np.zeros((p, p))
        g = np.zeros((p, d))
        for i in range(self.N):
            H += self.O[i].T @ self.O[i] / self.b
            g += self.O[i].T @ self.T[i] / self.b
        return np.linalg.solve(H, g)

    def accuracy(self, xs: np.ndarray, x_star: np.ndarray, x_init: np.ndarray) -> float:
        """Relative error metric of eq. (23)."""
        num = np.linalg.norm(
            (xs - x_star[None]).reshape(self.N, -1), axis=1
        )
        den = np.linalg.norm(
            (x_init - x_star[None]).reshape(self.N, -1), axis=1
        )
        return float(np.mean(num / np.maximum(den, 1e-12)))


def allocate(dataset: Dataset, N: int, K: int = 1) -> LeastSquaresProblem:
    """Disjointly allocate a dataset across N agents (paper §V-A).

    Truncates to b = floor(n / N) samples per agent, with b further floored
    to a multiple of K so ECN partitions are equal-sized.
    """
    n = dataset.O_train.shape[0]
    b = (n // N // K) * K
    if b == 0:
        raise ValueError(f"dataset {dataset.name} too small for N={N}, K={K}")
    O = dataset.O_train[: N * b].reshape(N, b, dataset.p)
    T = dataset.T_train[: N * b].reshape(N, b, dataset.d)
    return LeastSquaresProblem(
        O, T, dataset.O_test, dataset.T_test, name=dataset.name
    )
