"""Plain PyTorch versions of the coded-combine kernels (the CPU path and
the yardstick the CUDA kernels are held against).

Counterparts of `repro.kernels.ref.coded_combine_ref` and
`coded_admm_update_ref`, with an explicit leading runs axis R in place of
the reference's ``vmap``. Same semantics, including the accumulation
dtype: ``promote(dtype, float32)``, so bf16 and f32 accumulate in f32 and
f64 stays f64.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["compute_dtype", "coded_combine_ref", "coded_admm_update_ref"]


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of both kernels: at least float32."""
    return torch.promote_types(dtype, torch.float32)


def coded_combine_ref(
    msgs: torch.Tensor,  # (R, J, n)
    coeffs: torch.Tensor,  # (R, J)
    mask: Optional[torch.Tensor] = None,  # (R, J) alive rows (>0)
) -> torch.Tensor:
    """out (R, n) = sum_j coeffs[:, j] * [mask[:, j] > 0] * msgs[:, j] in
    the accumulation dtype.

    ``mask`` where-zeroes dead rows BEFORE the reduction, mirroring the
    kernel's NaN-safe guard (0 * NaN would be NaN, where is not).
    """
    ct = compute_dtype(msgs.dtype)
    m = msgs.to(ct)
    if mask is not None:
        m = torch.where(mask[..., None] > 0, m, torch.zeros((), dtype=ct))
    return torch.einsum("rj,rjn->rn", coeffs.to(ct), m)


def coded_admm_update_ref(
    msgs: torch.Tensor,  # (R, J, n) coded gradient messages
    coeffs: torch.Tensor,  # (R, J) decode vector (includes eq. 6's 1/K)
    x: torch.Tensor,  # (R, n)
    y: torch.Tensor,  # (R, n)
    z: torch.Tensor,  # (R, n)
    tau: torch.Tensor,  # (R,) tau^k
    rho: torch.Tensor,  # (R,)
    mask: Optional[torch.Tensor] = None,  # (R, J) alive rows (>0)
) -> torch.Tensor:
    """Fused decode + proximal x-update (eq. 5a), per run r:

    G = sum_j coeffs[j] mask[j] msgs[j];
    x+ = (tau x + rho z + y - G) / (rho + tau), returned in ``x.dtype``.
    """
    G = coded_combine_ref(msgs, coeffs, mask)
    ct = G.dtype
    t = tau.to(ct)[:, None]
    r = rho.to(ct)[:, None]
    num = t * x.to(ct) + r * z.to(ct) + y.to(ct) - G
    return (num / (r + t)).to(x.dtype)
