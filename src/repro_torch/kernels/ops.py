"""Public entry points of the coded-combine kernels, dispatched by device.

Counterpart of the coded half of `repro.kernels.ops`. A CUDA tensor goes to
the hand-written kernel (`repro_torch.kernels.coded_combine`) or the call
raises; a CPU tensor goes to the plain PyTorch version
(`repro_torch.kernels.ref`); any other device raises. There is no fallback
from one to the other.

Unlike the reference, nothing is padded: the TPU kernel needs 128-lane
tiles (hence ``fit_block_n``/``_pad_to`` there), while the CUDA kernel masks
its own ragged edge, so padding would only add (J + 3) * n of copies per
step. Shapes carry an explicit runs axis: msgs (R, J, n), coeffs/mask
(R, J), x/y/z (R, n), tau/rho (R,).
"""

from __future__ import annotations

from typing import Optional

import torch

from .coded_combine import coded_admm_update_kernel, coded_combine_kernel
from .ref import coded_admm_update_ref, coded_combine_ref, compute_dtype

__all__ = ["coded_combine", "coded_admm_update"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no coded-combine path for device {t.device}")


def _in_acc_dtype(ct: torch.dtype, coeffs, mask, *scalars):
    """coeffs, the alive mask (all-alive when None) and the per-run scalars
    as contiguous tensors of the accumulation dtype, the layout the kernel
    reads. The main path's step inputs already have it, so there this
    copies nothing and launches nothing."""
    if mask is None:
        mask = torch.ones_like(coeffs)
    return tuple(t.to(ct).contiguous() for t in (coeffs, mask, *scalars))


def coded_combine(
    msgs: torch.Tensor,
    coeffs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """sum_j coeffs[:, j] * [mask[:, j] > 0] * msgs[:, j] -> (R, n) in the
    accumulation dtype. Dead rows are where-zeroed before the reduction, so
    garbage (even NaN) in never-arrived messages cannot leak into the
    decode. ``mask`` None = all rows alive."""
    if not _on_cuda(msgs):
        return coded_combine_ref(msgs, coeffs, mask)
    coeffs, mask = _in_acc_dtype(compute_dtype(msgs.dtype), coeffs, mask)
    return coded_combine_kernel(msgs.contiguous(), coeffs, mask)


def coded_admm_update(
    msgs: torch.Tensor,
    coeffs: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    tau: torch.Tensor,
    rho: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused decode + eq. (5a) x-update over flat parameter vectors, per run:
    x+ = (tau x + rho z + y - coded_combine(msgs, coeffs, mask)) / (rho + tau),
    in ``x.dtype``. ``coeffs``, ``tau``, ``rho`` and ``mask`` are runtime
    data (per-run, per-step schedule values), never compile-time constants.
    On CUDA, msgs and x/y/z must share one dtype (the kernel raises
    otherwise).
    """
    if not _on_cuda(msgs):
        return coded_admm_update_ref(msgs, coeffs, x, y, z, tau, rho, mask)
    coeffs, mask, tau, rho = _in_acc_dtype(
        compute_dtype(msgs.dtype), coeffs, mask, tau, rho
    )
    return coded_admm_update_kernel(
        msgs.contiguous(), coeffs, mask, x.contiguous(), y.contiguous(),
        z.contiguous(), tau, rho,
    )
