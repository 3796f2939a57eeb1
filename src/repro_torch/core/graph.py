"""Decentralized network topologies and token-traversal cycles — paper §II, §V-A.

The experimental network G has N agents and E = N(N-1)/2 * eta links (eta =
connectivity ratio). Token traversal patterns (Fig. 1):

  (a) Hamiltonian cycle — visits each agent exactly once per cycle;
  (b) shortest-path cycle — concatenation of shortest paths between the
      Hamiltonian order when no Hamiltonian cycle exists / as an alternative
      walking pattern (WPG-style [5]); agents may be visited more than once,
      which inflates communication cost per cycle.

All graphs are guaranteed connected (Assumption 1) by construction: we start
from a random Hamiltonian ring and add extra random edges up to the target
connectivity ratio. This both matches the paper's simulation setup and makes
Assumption 1 (existence of a Hamiltonian cycle) hold by construction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["Network", "make_network", "metropolis_weights"]


@dataclasses.dataclass(frozen=True)
class Network:
    """An undirected connected agent graph with traversal cycles."""

    N: int
    edges: Tuple[Tuple[int, int], ...]  # undirected, i < j
    hamiltonian: Tuple[int, ...]  # agent order, length N
    shortest_path_cycle: Tuple[int, ...]  # token route, length >= N

    @property
    def E(self) -> int:
        return len(self.edges)

    @property
    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.N, self.N), dtype=bool)
        for i, j in self.edges:
            A[i, j] = A[j, i] = True
        return A

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adjacency[i])[0]

    def degree(self) -> np.ndarray:
        return self.adjacency.sum(1)


def _shortest_paths(A: np.ndarray) -> np.ndarray:
    """All-pairs hop distances (BFS per source). A: (N, N) bool."""
    N = A.shape[0]
    dist = np.full((N, N), np.inf)
    for s in range(N):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in np.nonzero(A[u])[0]:
                    if dist[s, v] == np.inf:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def _bfs_path(A: np.ndarray, s: int, t: int) -> List[int]:
    """One shortest path s -> t (list of vertices incl. both ends)."""
    N = A.shape[0]
    prev = -np.ones(N, dtype=int)
    prev[s] = s
    frontier = [s]
    while frontier and prev[t] < 0:
        nxt = []
        for u in frontier:
            for v in np.nonzero(A[u])[0]:
                if prev[v] < 0:
                    prev[v] = u
                    nxt.append(v)
        frontier = nxt
    path = [t]
    while path[-1] != s:
        path.append(int(prev[path[-1]]))
    return path[::-1]


def make_network(N: int, connectivity: float = 0.5, seed: int = 0) -> Network:
    """Random connected graph with a planted Hamiltonian ring (paper §V-A).

    Args:
      N: number of agents.
      connectivity: eta, so that E ~= eta * N(N-1)/2 (>= the ring's N edges).
      seed: PRNG seed.
    """
    if N < 3:
        raise ValueError("need N >= 3 agents")
    rng = np.random.default_rng(seed)
    order = rng.permutation(N)
    edges = set()
    for a in range(N):
        i, j = int(order[a]), int(order[(a + 1) % N])
        edges.add((min(i, j), max(i, j)))
    target = max(N, int(round(connectivity * N * (N - 1) / 2)))
    all_pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    rng.shuffle(all_pairs)
    for i, j in all_pairs:
        if len(edges) >= target:
            break
        edges.add((i, j))
    A = np.zeros((N, N), dtype=bool)
    for i, j in edges:
        A[i, j] = A[j, i] = True

    # Shortest-path cycle: concatenate shortest paths between consecutive
    # agents of a random visiting order (WPG-style [5]). Route includes the
    # intermediate relays, so its length is >= N.
    visit = [int(v) for v in rng.permutation(N)]
    route: List[int] = [visit[0]]
    for a in range(N):
        s, t = visit[a], visit[(a + 1) % N]
        route.extend(_bfs_path(A, s, t)[1:])
    route = route[:-1]  # last hop returns to start; cycle is implicit

    return Network(
        N=N,
        edges=tuple(sorted(edges)),
        hamiltonian=tuple(int(v) for v in order),
        shortest_path_cycle=tuple(route),
    )


def metropolis_weights(net: Network) -> np.ndarray:
    """Symmetric doubly-stochastic mixing matrix W (for DGD/EXTRA baselines)."""
    A = net.adjacency
    deg = A.sum(1)
    W = np.zeros((net.N, net.N))
    for i, j in net.edges:
        w = 1.0 / (1 + max(deg[i], deg[j]))
        W[i, j] = W[j, i] = w
    np.fill_diagonal(W, 1.0 - W.sum(1))
    return W
