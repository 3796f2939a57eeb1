"""Shared LM loss with optional per-row weights (port of
`repro.models.losses`).

Per-row weights are how the reference's distributed csI-ADMM runtime
expresses MDS encode/decode over ECN batch partitions: the gradient is
linear in per-example losses, so a decode folds into one weighted
backward pass with row weight a_j * B[j, t].
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["lm_loss"]


def lm_loss(
    logits: torch.Tensor,  # (B, S, V), any float dtype; promoted to >= f32
    labels: torch.Tensor,  # (B, S) int, < 0 => ignore
    row_weights: Optional[torch.Tensor] = None,  # (B,)
) -> torch.Tensor:
    """Mean token NLL; with row_weights, sum_b w_b * (mean token NLL of row
    b). A "row" is one example, its loss the mean NLL over its unmasked
    positions."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    labels = labels.long()
    mask = labels >= 0
    lab = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (logz - gold) * mask
    if row_weights is None:
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    row_loss = nll.sum(-1) / torch.clamp(mask.sum(-1), min=1)
    return torch.sum(row_weights.to(row_loss.dtype) * row_loss)
