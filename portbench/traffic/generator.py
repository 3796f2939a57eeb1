"""The one generator every traffic mix of the benchmark reads.

A frozen copy of the port's host side of LM training:
`src/repro_torch/data/lm.py` (``TokenStream``, ``agent_token_streams``,
``make_lm_batch``, numpy, bitwise the same tokens) and
`src/repro_torch/launch/train.py::consensus_batches` (the coded
allocation of rows and the straggler draws). The benchmark keeps its own
copy so that no later change to the program can change the inputs it is
measured on.

A mix is a JSON file beside this one. ``feed(traffic, vocab, seed)``
yields one step's inputs at a time as ``(batch, alive)``: ``batch`` maps
``tokens``/``labels`` to int32 arrays of (rows, seq), and ``alive`` is
the (agents, ecns) ECN response mask of a coded mix, or None.

- A coded mix (``ecns`` in the file): each of ``agents`` agents samples
  ``ecns`` partitions of ``rows_per_partition`` rows from its own stream
  and lays partition t out on every ECN whose support holds it (the
  cyclic support of ECN j is {j, ..., j + S} mod K, in ascending order),
  so a step has agents * ecns * (stragglers + 1) * rows_per_partition
  rows; then ``stragglers`` of each agent's ECNs are drawn dead
  (``default_rng(seed + 7)``).
- A plain mix: ``rows`` rows from one stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["TokenStream", "agent_token_streams", "make_lm_batch", "cyclic_support",
           "feed", "rows_per_step"]


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic token stream (Markov + noise mixture)."""

    vocab: int
    seed: int
    branching: int = 4  # successors per state
    noise: float = 0.05

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        self._rng = np.random.default_rng(self.seed + 1)
        self._state = int(self._rng.integers(0, self.vocab))

    def sample(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        s = self._state
        succ, rng, V = self._succ, self._rng, self.vocab
        noise_mask = rng.random(n) < self.noise
        choices = rng.integers(0, self.branching, size=n)
        noise_tok = rng.integers(0, V, size=n)
        for t in range(n):
            if noise_mask[t]:
                s = int(noise_tok[t])
            else:
                s = int(succ[s, choices[t]])
            out[t] = s
        self._state = s
        return out


def agent_token_streams(n_agents: int, vocab: int, seed: int = 0) -> List[TokenStream]:
    """One disjoint stream per agent (own seed => own transition matrix)."""
    return [TokenStream(vocab=vocab, seed=seed * 1000 + i) for i in range(n_agents)]


def make_lm_batch(stream: TokenStream, batch: int, seq_len: int) -> Dict[str, np.ndarray]:
    """Next-token-prediction batch: labels are tokens shifted left."""
    raw = stream.sample(batch * (seq_len + 1)).reshape(batch, seq_len + 1)
    return {
        "tokens": raw[:, :-1].astype(np.int32),
        "labels": raw[:, 1:].astype(np.int32),
    }


def cyclic_support(K: int, S: int) -> List[np.ndarray]:
    """The partitions ECN j stores under the cyclic code, ascending."""
    return [np.sort((j + np.arange(S + 1)) % K) for j in range(K)]


def rows_per_step(traffic: dict) -> int:
    if "ecns" in traffic:
        return (traffic["agents"] * traffic["ecns"] * (traffic["stragglers"] + 1)
                * traffic["rows_per_partition"])
    return traffic["rows"]


def feed(traffic: dict, vocab: int, seed: int
         ) -> Iterator[Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]]:
    """Endless steps of the mix, drawn from ``seed``."""
    seq = traffic["seq"]
    if "ecns" not in traffic:
        stream = agent_token_streams(1, vocab, seed=seed)[0]
        while True:
            yield make_lm_batch(stream, traffic["rows"], seq), None
    A, K, S = traffic["agents"], traffic["ecns"], traffic["stragglers"]
    P = traffic["rows_per_partition"]
    sup = cyclic_support(K, S)
    streams = agent_token_streams(A, vocab, seed=seed)
    rng = np.random.default_rng(seed + 7)
    while True:
        rows = []
        for a in range(A):
            parts = [make_lm_batch(streams[a], P, seq) for _ in range(K)]
            for j in range(K):
                for t in sup[j]:
                    rows.append(parts[t])
        batch = {key: np.concatenate([r[key] for r in rows], axis=0) for key in rows[0]}
        alive = np.ones((A, K), bool)
        for a in range(A):  # straggler event: drop S random ECNs
            dead = rng.choice(K, size=S, replace=False)
            alive[a, dead] = False
        yield batch, alive
