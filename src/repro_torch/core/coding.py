"""(K, R) gradient coding over the real field — paper §III-B, as a
pluggable code-family subsystem (DESIGN.md §11).

A *family* is one construction recipe (feasibility rule + certified
builder); a built `GradientCode` is the runtime artifact every consumer
shares (the schedule sampler, the method kernels, the fused CUDA combine
path). Registered families:

- **fractional**: Tandon et al. [23] deterministic 0/1 encoding. The K
  ECNs split into (S+1) groups of K/(S+1); each group disjointly covers
  all K partitions, so any K-S alive ECNs contain an intact group
  (pigeonhole) whose indicator is the decode vector. Needs (S+1) | K.
- **cyclic**: Tandon et al.'s randomized construction. ECN j holds
  partitions {j, ..., j+S} (mod K); draw H in R^{S x K} with H @ 1 = 0
  and read row j of B off null(H) restricted to the support. rowspan(B)
  = null(H) contains the all-ones vector and any K-S rows span it
  (general position) — certified at construction, re-drawn on failure.
  The paper's Fig. 2 example (K=3, S=1) is this scheme:
      g1 = 1/2 g~1 + g~2 ,  g2 = g~2 - g~3 ,  g3 = 1/2 g~1 + g~3.
- **mds**: real-field MDS code. B = W @ V with W the (K, R) Vandermonde
  matrix on Chebyshev nodes (any R rows invertible) and V an (R, K)
  orthonormal basis whose rowspan contains 1_K, so ANY >= R responses
  decode exactly via least squares. Dense rows: replication = K (full
  storage/compute), the classic MDS storage-for-flexibility trade.
- **approx**: partial-recovery gradient code (the approximate gradient
  coding regime of Raviv et al. / the compressed-stochastic extensions
  of arXiv 2501.13516). Same B and storage as cyclic — exact from any
  R = K - S responses — but decode is *also* defined for as few as
  r_min = max(1, K - 2S) responses, with the worst-case least-squares
  residual over all r_min-size alive patterns certified at construction
  as ``err_bound``: for any alive set with >= r_min responses,
  |a^T B g - 1^T g| <= err_bound * ||g||_2 per gradient coordinate.
  This is what the decode *deadline* of
  `repro_torch.core.timing.TimingModel` cashes in (DESIGN.md §11).
- **uncoded**: disjoint allocation (sI-ADMM, Algorithm 1): B = I, the
  agent must hear from every ECN (S = 0).

Encoding/decoding are linear maps over stacked partition gradients, so
the same matrices drive the faithful simulator (`repro_torch.core.admm`)
and the fused CUDA combine (`repro_torch.kernels.coded_combine`), where
decode becomes a masked weighted reduction over message rows.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import numpy as np

__all__ = [
    "GradientCode",
    "CodeFamily",
    "CODE_FAMILIES",
    "register_family",
    "make_code",
    "check_arm_set",
    "make_arm_set",
    "fractional_repetition_code",
    "cyclic_repetition_code",
    "mds_code",
    "approx_code",
    "uncoded",
    "paper_fig2_code",
]


@dataclasses.dataclass(frozen=True)
class GradientCode:
    """A certified (K, R) gradient code.

    Attributes:
      name: family name ("fractional", "cyclic", "mds", "approx",
        "uncoded").
      K: number of ECNs (= number of data partitions, d = n in [23]).
      S: number of tolerated stragglers; R = K - S responses decode
        exactly (for exact families).
      B: (K, K) encode matrix. ECN j transmits ``B[j] @ partial_grads``
        where ``partial_grads`` stacks the K per-partition gradients.
        Row support of B[j] is the set of partitions ECN j must
        store/compute.
      r_min: minimum responses ``decode_vector`` accepts; ``None`` means
        R (exact-only decode). Partial-recovery families set r_min < R.
      err_bound: certified worst-case decode residual
        max_{|alive| >= r_min} min_a ||B[alive]^T a - 1||_2 — zero for
        exact families. The decoded gradient sum errs by at most
        ``err_bound * ||g||_2`` per coordinate (Cauchy-Schwarz).
    """

    name: str
    K: int
    S: int
    B: np.ndarray  # (K, K) float64
    r_min: Optional[int] = None
    err_bound: float = 0.0

    @property
    def R(self) -> int:
        return self.K - self.S

    @property
    def min_responses(self) -> int:
        """Fewest responses decode accepts (R unless partial recovery)."""
        return self.R if self.r_min is None else self.r_min

    @property
    def exact(self) -> bool:
        """True iff every accepted alive pattern decodes exactly."""
        return self.err_bound == 0.0

    def support(self, j: int) -> np.ndarray:
        """Partition indices ECN j computes gradients for."""
        return np.nonzero(np.abs(self.B[j]) > 1e-12)[0]

    @property
    def replication(self) -> int:
        """Max #partitions per ECN (storage/compute overhead factor)."""
        return int(max(len(self.support(j)) for j in range(self.K)))

    def encode(self, partial_grads: np.ndarray) -> np.ndarray:
        """Coded messages from stacked per-partition gradients (K, ...)."""
        g = np.asarray(partial_grads)
        return np.tensordot(self.B, g.reshape(self.K, -1), axes=1).reshape(
            g.shape
        )

    def _decode_tol(self) -> float:
        return 1e-6 if self.exact else self.err_bound * (1 + 1e-6) + 1e-9

    def decode_vector(self, alive: np.ndarray) -> np.ndarray:
        """a with a^T B ~= 1^T and a supported on alive ECNs.

        ``alive`` is a boolean mask of length K with >= ``min_responses``
        True entries. Exact families require an exact solve (residual
        <= 1e-6); partial-recovery families accept any residual within
        the certified ``err_bound``. Raises ValueError otherwise.
        """
        alive = np.asarray(alive, dtype=bool)
        if alive.sum() < self.min_responses:
            raise ValueError(
                f"need >= r_min={self.min_responses} responses, "
                f"got {int(alive.sum())}"
            )
        idx = np.nonzero(alive)[0]
        # Least-squares decode: exactness (or the certified bound) is
        # asserted, so the returned vector is always usable.
        ones = np.ones(self.K)
        a_idx, *_ = np.linalg.lstsq(self.B[idx].T, ones, rcond=None)
        resid = np.linalg.norm(self.B[idx].T @ a_idx - ones)
        if resid > self._decode_tol():
            raise ValueError(
                f"alive set {idx.tolist()} is not decodable "
                f"(residual {resid:.3g} > certified {self._decode_tol():.3g})"
            )
        a = np.zeros(self.K)
        a[idx] = a_idx
        return a

    def decode_error(self, alive: np.ndarray) -> float:
        """Residual ||a^T B - 1^T||_2 of the lstsq decode for ``alive``.

        Zero (to fp) for exact families with >= R alive; bounded by
        ``err_bound`` for any accepted pattern of a partial-recovery
        family (the residual is non-increasing in the alive set).
        """
        a = self.decode_vector(alive)
        return float(np.linalg.norm(a @ self.B - np.ones(self.K)))

    def decode(self, messages: np.ndarray, alive: np.ndarray) -> np.ndarray:
        """Full-batch gradient sum from alive coded messages.

        ``messages``: (K, ...) coded gradients (rows for dead ECNs
        ignored). Returns sum_t partial_grads[t] (shape =
        messages.shape[1:]), exactly for exact families and within
        ``err_bound * ||g||`` per coordinate otherwise.
        """
        a = self.decode_vector(alive)
        m = np.asarray(messages).reshape(self.K, -1)
        return (a @ m).reshape(np.asarray(messages).shape[1:])

    def _patterns(self, n_dead: int, max_patterns: int, rng):
        """Alive masks with exactly ``n_dead`` dead ECNs (exhaustive when
        C(K, n_dead) <= max_patterns, else a seeded random sample)."""
        if n_dead == 0:
            deads = [()]
        elif _ncr(self.K, n_dead) <= max_patterns:
            deads = itertools.combinations(range(self.K), n_dead)
        else:
            rng = rng or np.random.default_rng(0)
            deads = [
                tuple(rng.choice(self.K, size=n_dead, replace=False))
                for _ in range(max_patterns)
            ]
        for dead in deads:
            alive = np.ones(self.K, dtype=bool)
            alive[list(dead)] = False
            yield alive

    def verify(
        self,
        max_patterns: int = 4096,
        rng: Optional[np.random.Generator] = None,
    ) -> bool:
        """Certify decodability of every accepted straggler pattern.

        Patterns of exactly S dead ECNs and — for partial-recovery
        families — the worst accepted patterns of K - r_min dead must
        all decode within the family's certified tolerance (exactly for
        exact families, within ``err_bound`` otherwise; the ISSUE/test
        contract is "exact, or within the certified bound"). Exhaustive
        when the pattern count is small, else sampled.
        """
        checks = [self.S]
        if self.min_responses < self.R:
            checks.append(self.K - self.min_responses)
        for n_dead in checks:
            for alive in self._patterns(n_dead, max_patterns, rng):
                try:
                    self.decode_vector(alive)
                except ValueError:
                    return False
        return True


def _ncr(n: int, r: int) -> int:
    import math

    return math.comb(n, r)


# --------------------------------------------------------------------------
# Constructions
# --------------------------------------------------------------------------


def fractional_repetition_code(K: int, S: int) -> GradientCode:
    """Fractional repetition scheme of [23] (requires (S+1) | K)."""
    _check_KS(K, S, "fractional")
    if K % (S + 1) != 0:
        raise ValueError(
            f"fractional repetition needs (S+1) | K; got K={K}, S={S}"
        )
    m = K // (S + 1)  # workers per group
    B = np.zeros((K, K))
    for g in range(S + 1):  # group index
        for j in range(m):  # member index within group
            worker = g * m + j
            parts = np.arange(j * (S + 1), (j + 1) * (S + 1))
            B[worker, parts] = 1.0
    return GradientCode("fractional", K, S, B)


def _cyclic_B(K: int, S: int, seed: int, max_tries: int) -> np.ndarray:
    """The certified cyclic-support encode matrix (shared by the cyclic
    and approx families)."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        # H in R^{S x K} with H @ 1 = 0; rowspan(B) = null(H) which
        # contains the all-ones vector (Tandon et al., randomized).
        H = rng.standard_normal((S, K))
        H[:, -1] -= H.sum(axis=1)
        B = np.zeros((K, K))
        ok = True
        for j in range(K):
            cols = (j + np.arange(S + 1)) % K
            Hs = H[:, cols]  # (S, S+1): 1-dim null space generically
            _, sv, Vt = np.linalg.svd(Hs)
            if S > 0 and sv[-1] < 1e-10:
                ok = False  # degenerate draw; retry
                break
            coef = Vt[-1]  # null vector of Hs
            # Scale so coefficients sum to S+1 (matches the uncoded
            # convention where each row "covers" S+1 partitions; any
            # nonzero scale works for decodability).
            ssum = coef.sum()
            if abs(ssum) < 1e-10:
                ok = False
                break
            coef = coef * ((S + 1) / ssum)
            B[j, cols] = coef
        if ok and GradientCode("cyclic", K, S, B).verify():
            return B
    raise RuntimeError(
        f"failed to draw a decodable cyclic code for K={K}, S={S}"
    )


def cyclic_repetition_code(
    K: int, S: int, seed: int = 0, max_tries: int = 16
) -> GradientCode:
    """Cyclic repetition scheme of [23] (randomized construction,
    certified via :meth:`GradientCode.verify` before returning)."""
    _check_KS(K, S, "cyclic")
    if S == 0:
        return GradientCode("cyclic", K, 0, np.eye(K))
    return GradientCode("cyclic", K, S, _cyclic_B(K, S, seed, max_tries))


def mds_code(K: int, S: int, seed: int = 0) -> GradientCode:
    """Real-field MDS gradient code: Vandermonde encode, lstsq decode.

    B = W @ V where W is the (K, R) Vandermonde matrix on Chebyshev
    nodes (any R of its rows are invertible — distinct real nodes) and
    V is an (R, K) orthonormal row basis whose span contains 1_K. For
    ANY alive set with >= R responses, B[alive] = W[alive] @ V has
    rowspan(V) as its rowspan, so the all-ones decode target is always
    reachable: exact decode from *any* R-subset, not just the fastest.
    The price is dense rows — replication = K (every ECN computes every
    partition), the MDS end of the storage/flexibility frontier.
    """
    _check_KS(K, S, "mds")
    R = K - S
    # Chebyshev nodes keep the real Vandermonde well conditioned at the
    # K <= O(16) ECN counts this simulator sweeps.
    nodes = np.cos((2 * np.arange(K) + 1) * np.pi / (2 * K))
    W = np.vander(nodes, R, increasing=True)  # (K, R)
    rng = np.random.default_rng(seed)
    basis = np.concatenate(
        [np.ones((K, 1)) / np.sqrt(K), rng.standard_normal((K, R - 1))],
        axis=1,
    )
    V = np.linalg.qr(basis)[0].T  # (R, K), rowspan contains 1_K
    code = GradientCode("mds", K, S, W @ V)
    if not code.verify():  # pragma: no cover - deterministic construction
        raise RuntimeError(f"mds construction failed for K={K}, S={S}")
    return code


def approx_code(
    K: int, S: int, seed: int = 0, max_patterns: int = 4096
) -> GradientCode:
    """Partial-recovery gradient code with a certified error bound.

    Storage and exact-decode behavior are identical to the cyclic
    scheme (same certified B, support size S+1, exact from any
    R = K - S responses), but decode is additionally defined down to
    r_min = max(1, K - 2S) responses via least squares. ``err_bound``
    is the exact worst-case residual ||a^T B - 1^T||_2 over ALL
    r_min-size alive patterns when their count is <= ``max_patterns``
    (every K this simulator sweeps); above that, enumeration is skipped
    and the *provable* bound ||1||_2 = sqrt(K) is certified instead
    (a = 0 is feasible, lstsq only improves on it) — loose, but an
    unsampled runtime pattern can never exceed it and crash a schedule
    mid-sweep. This is the bounded-error decode the deadline path of
    `repro_torch.core.timing.TimingModel` selects when fewer than R ECNs
    respond in time (DESIGN.md §11).
    """
    _check_KS(K, S, "approx")
    if S < 1:
        raise ValueError(
            f"approx (partial recovery) needs S >= 1; got K={K}, S={S}"
        )
    B = _cyclic_B(K, S, seed, max_tries=16)
    r_min = max(1, K - 2 * S)
    if _ncr(K, K - r_min) > max_patterns:
        return GradientCode(
            "approx", K, S, B, r_min=r_min, err_bound=float(np.sqrt(K))
        )
    ones = np.ones(K)
    worst = 0.0
    probe = GradientCode("approx", K, S, B, r_min=r_min, err_bound=np.inf)
    for alive in probe._patterns(K - r_min, max_patterns, None):
        idx = np.nonzero(alive)[0]
        a, *_ = np.linalg.lstsq(B[idx].T, ones, rcond=None)
        worst = max(worst, float(np.linalg.norm(B[idx].T @ a - ones)))
    return GradientCode("approx", K, S, B, r_min=r_min, err_bound=worst)


def uncoded(K: int) -> GradientCode:
    """Disjoint allocation (sI-ADMM, Algorithm 1): B = I, must wait for
    all K ECNs."""
    return GradientCode("uncoded", K, 0, np.eye(K))


def paper_fig2_code() -> GradientCode:
    """The exact (K=3, S=1) example of the paper's Fig. 2."""
    B = np.array(
        [
            [0.5, 1.0, 0.0],
            [0.0, 1.0, -1.0],
            [0.5, 0.0, 1.0],
        ]
    )
    return GradientCode("cyclic", 3, 1, B)


def _check_KS(K: int, S: int, name: str) -> None:
    """The shared (K, S) range check — one message format for both the
    `make_code` registry path and direct builder calls."""
    if K < 1 or S < 0 or S >= K:
        raise ValueError(
            f"{name!r} code infeasible: need 0 <= S < K "
            f"(got K={K}, S={S})"
        )


# --------------------------------------------------------------------------
# Family registry (DESIGN.md §11)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodeFamily:
    """One registered construction: feasibility rule + certified builder.

    Attributes:
      name: registry key (= `GradientCode.name` of built codes).
      exact: True iff every accepted pattern decodes exactly (err_bound
        is identically 0); partial-recovery families set False.
      replication: human-readable storage overhead formula, for docs
        and the README's family-selection table.
      build: ``(K, S, seed) -> GradientCode`` (certified on return).
      feasible: ``(K, S) -> Optional[str]`` — None when (K, S) is
        constructible, else the reason, which `make_code` turns into a
        uniform, actionable ValueError *before* any construction math
        can fail cryptically.
    """

    name: str
    exact: bool
    replication: str
    build: "object"
    feasible: "object"

    def check(self, K: int, S: int) -> None:
        """Raise the family's feasibility error for (K, S), if any."""
        _check_KS(K, S, self.name)
        reason = self.feasible(K, S)
        if reason is not None:
            raise ValueError(
                f"{self.name!r} code infeasible for K={K}, S={S}: {reason}"
            )


CODE_FAMILIES: Dict[str, CodeFamily] = {}


def register_family(family: CodeFamily) -> CodeFamily:
    if family.name in CODE_FAMILIES:
        raise ValueError(f"duplicate code family {family.name!r}")
    CODE_FAMILIES[family.name] = family
    return family


register_family(
    CodeFamily(
        "uncoded",
        exact=True,
        replication="1",
        build=lambda K, S, seed: uncoded(K),
        feasible=lambda K, S: (
            None if S == 0 else "uncoded tolerates no stragglers (S must be 0)"
        ),
    )
)
register_family(
    CodeFamily(
        "fractional",
        exact=True,
        replication="S+1",
        build=lambda K, S, seed: fractional_repetition_code(K, S),
        feasible=lambda K, S: (
            None
            if K % (S + 1) == 0
            else f"needs (S+1) | K, but {S + 1} does not divide {K}"
        ),
    )
)
register_family(
    CodeFamily(
        "cyclic",
        exact=True,
        replication="S+1",
        build=lambda K, S, seed: cyclic_repetition_code(K, S, seed=seed),
        feasible=lambda K, S: None,
    )
)
register_family(
    CodeFamily(
        "mds",
        exact=True,
        replication="K",
        build=lambda K, S, seed: mds_code(K, S, seed=seed),
        feasible=lambda K, S: None,
    )
)
register_family(
    CodeFamily(
        "approx",
        exact=False,
        replication="S+1",
        build=lambda K, S, seed: approx_code(K, S, seed=seed),
        feasible=lambda K, S: (
            None if S >= 1 else "partial recovery needs S >= 1"
        ),
    )
)


def make_code(scheme: str, K: int, S: int, seed: int = 0) -> GradientCode:
    """Factory over the family registry.

    Validates feasibility FIRST, so infeasible (K, S) always surfaces as
    a uniform ``ValueError: '<family>' code infeasible ...`` rather than
    a construction-internal null-space or divisibility failure.
    """
    if scheme not in CODE_FAMILIES:
        raise ValueError(
            f"unknown code family {scheme!r}; known: "
            f"{sorted(CODE_FAMILIES)}"
        )
    family = CODE_FAMILIES[scheme]
    family.check(K, S)
    return family.build(K, S, seed)


# --------------------------------------------------------------------------
# Arm sets for the online controller (DESIGN.md §15)
# --------------------------------------------------------------------------


def check_arm_set(arms, K: int) -> None:
    """Validate a controller arm set without building anything.

    ``arms`` is a sequence of ``(scheme, S, deadline)`` cells — the
    frontier coordinates the bandit of `repro_torch.control` selects
    among.
    EVERY arm is checked before ANY code is constructed, so an
    infeasible cell surfaces at arm-set construction with the same
    uniform ``'<family>' code infeasible`` message `make_code` raises —
    never as a trace-time or mid-sweep failure. Also rejects empty and
    duplicate arm sets (a duplicate arm is a spec bug: the controller
    would split pulls across indistinguishable cells).
    """
    if not arms:
        raise ValueError("arm set is empty: the controller needs >= 1 arm")
    seen = set()
    for arm in arms:
        if len(arm) != 3:
            raise ValueError(
                f"arm {arm!r} is not a (scheme, S, deadline) triple"
            )
        scheme, S, deadline = arm
        if scheme not in CODE_FAMILIES:
            raise ValueError(
                f"unknown code family {scheme!r}; known: "
                f"{sorted(CODE_FAMILIES)}"
            )
        CODE_FAMILIES[scheme].check(K, int(S))
        if deadline is not None and deadline <= 0:
            raise ValueError(
                f"arm {arm!r}: deadline must be positive or None"
            )
        key = (scheme, int(S), deadline)
        if key in seen:
            raise ValueError(f"duplicate arm {arm!r} in arm set")
        seen.add(key)


def make_arm_set(arms, K: int, seed: int = 0) -> "tuple":
    """Build the certified codes of a controller arm set.

    Feasibility of the WHOLE set is pre-checked (:func:`check_arm_set`)
    before the first build, so nothing is half-constructed when a later
    arm is infeasible. Returns one `GradientCode` per arm, in arm order.
    """
    check_arm_set(arms, K)
    return tuple(
        make_code(scheme, K, int(S), seed=seed) for scheme, S, _ in arms
    )
