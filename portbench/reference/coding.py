"""The coded rows' weights, worked out from the seed and the alive mask
alone (numpy, float64).

The encode matrix is the cyclic repetition code of Tandon et al. (ICML
2017), drawn as the port's `core/coding.py` draws it (same rng stream, so
the same B for the same seed): H (S, K) standard normal with rows summing
to 0, and row j of B the null vector of H's columns {j, ..., j + S} mod K,
scaled so its entries sum to S + 1; a draw is kept when every pattern of S
dead ECNs decodes. The decode vector is the least-norm a with a^T B_alive
= 1^T on the alive ECNs (0 on the dead). Row u of ECN j, which holds
partition t = support(j)[u], weighs a_j B[j, t] / (K P).
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["cyclic_B", "decode_vector", "row_weights"]


def _decodes(B: np.ndarray, alive: np.ndarray) -> bool:
    idx = np.nonzero(alive)[0]
    a, *_ = np.linalg.lstsq(B[idx].T, np.ones(B.shape[0]), rcond=None)
    return np.linalg.norm(B[idx].T @ a - 1.0) <= 1e-6


def cyclic_B(K: int, S: int, seed: int, max_tries: int = 16) -> np.ndarray:
    if S == 0:
        return np.eye(K)
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        H = rng.standard_normal((S, K))
        H[:, -1] -= H.sum(axis=1)
        B = np.zeros((K, K))
        ok = True
        for j in range(K):
            cols = (j + np.arange(S + 1)) % K
            _, sv, Vt = np.linalg.svd(H[:, cols])
            coef = Vt[-1]
            if sv[-1] < 1e-10 or abs(coef.sum()) < 1e-10:
                ok = False
                break
            B[j, cols] = coef * ((S + 1) / coef.sum())
        if not ok:
            continue
        patterns = []
        for dead in itertools.combinations(range(K), S):
            alive = np.ones(K, bool)
            alive[list(dead)] = False
            patterns.append(alive)
        if all(_decodes(B, al) for al in patterns):
            return B
    raise RuntimeError(f"no decodable cyclic code for K={K}, S={S}")


def decode_vector(B: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Least-norm a with a^T (B masked to the alive rows) = 1^T."""
    Bm = B * alive[:, None]
    a = np.linalg.pinv(Bm.T, rcond=1e-6) @ np.ones(B.shape[0])
    return np.where(alive, a, 0.0)


def row_weights(B: np.ndarray, alive: np.ndarray, S: int, P: int) -> np.ndarray:
    """(A, K (S + 1) P) row weights from the (A, K) alive mask, rows in the
    generator's order (ECN-major, then the ECN's partitions ascending, then
    the partition's rows)."""
    K = B.shape[0]
    out = []
    for mask in np.asarray(alive, bool):
        a = decode_vector(B, mask)
        w = []
        for j in range(K):
            for t in np.sort((j + np.arange(S + 1)) % K):
                w += [a[j] * B[j, t] / (K * P)] * P
        out.append(w)
    return np.asarray(out, np.float64)
