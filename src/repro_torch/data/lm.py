"""Token pipeline for LM training examples (copied whole from
`repro.data.lm`: numpy, bitwise the same tokens).

Offline container => synthetic corpora: a deterministic mixture of (a) an
order-k Markov chain over the vocabulary (so the model has actual structure
to learn; loss decreases measurably within a few hundred steps) and (b)
uniform noise tokens. Each agent gets a *disjoint* stream (its own seed and
transition matrix sub-block) matching the paper's disjoint-allocation
assumption; ECN sub-batches slice the agent batch exactly like the
least-squares path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = ["TokenStream", "agent_token_streams", "make_lm_batch"]


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic token stream (Markov + noise mixture)."""

    vocab: int
    seed: int
    branching: int = 4  # successors per state
    noise: float = 0.05

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse deterministic-ish transition structure
        self._succ = rng.integers(
            0, self.vocab, size=(self.vocab, self.branching)
        )
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


def agent_token_streams(
    n_agents: int, vocab: int, seed: int = 0
) -> List[TokenStream]:
    """One disjoint stream per agent (own seed => own transition matrix)."""
    return [
        TokenStream(vocab=vocab, seed=seed * 1000 + i) for i in range(n_agents)
    ]


def make_lm_batch(
    stream: TokenStream, batch: int, seq_len: int
) -> Dict[str, np.ndarray]:
    """Next-token-prediction batch: labels are tokens shifted left."""
    raw = stream.sample(batch * (seq_len + 1)).reshape(batch, seq_len + 1)
    return {
        "tokens": raw[:, :-1].astype(np.int32),
        "labels": raw[:, 1:].astype(np.int32),
    }
