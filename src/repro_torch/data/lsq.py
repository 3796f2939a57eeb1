"""Coded data allocation for the least-squares experiments (Algorithms 1-2).

Numpy copy of `repro.data.lsq`, bit for bit. The partition/batch-index
plumbing of the coded data layout:

- ``partition_for_code``: allocate an agent's local dataset across K ECNs
  following the code's row support (ECN j stores the partitions its encode
  row touches; disjoint for the uncoded identity code, (S+1)-replicated for
  fractional/cyclic repetition).
- ``ecn_batch_indices``: the paper's cyclic batch index
  I_{i,j}^k = m mod floor(|xi_{i,j}| * K / ((S+1) M_bar)) as absolute row
  offsets, so ECN j's mini-batch for cycle m is a static-size slice.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.coding import GradientCode

__all__ = ["partition_for_code", "ecn_batch_indices"]


def partition_for_code(
    b: int, code: GradientCode
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Split local row range [0, b) into K partitions + per-ECN supports.

    Returns (boundaries (K+1,), supports[j] = partition ids ECN j stores).
    Partition t owns rows [boundaries[t], boundaries[t+1]). Rows past
    b - b % K are dropped (static shapes).
    """
    K = code.K
    P = b // K
    if P == 0:
        raise ValueError(f"b={b} too small for K={K} partitions")
    boundaries = np.arange(K + 1) * P
    supports = [code.support(j) for j in range(K)]
    return boundaries, supports


def ecn_batch_indices(
    cycle: np.ndarray, P: int, mu: int
) -> np.ndarray:
    """Within-partition batch offsets for cycle indices m (paper step 15/16).

    Each partition of size P is cut into floor(P / mu) batches of size mu;
    cycle m selects batch m mod n_batches. Returns absolute offsets (len(m),).
    """
    nb = max(P // mu, 1)
    return ((np.asarray(cycle) % nb) * mu).astype(np.int32)
