"""Python bindings of the fused decode-combine (+ ADMM x-update) CUDA kernels.

Counterparts of the TPU kernels in `repro.kernels.coded_combine`
(``coded_combine_kernel`` and ``coded_admm_update_kernel``); the CUDA
source, its bound and its design are in ``csrc/coded_combine.cu``. The
reference gets its runs axis from ``vmap``; here it is explicit: msgs
(R, J, n), coeffs/mask (R, J), x/y/z (R, n), tau/rho (R,).

These wrappers only launch: they take CUDA tensors of exactly the layout
the kernel reads and raise on anything else (device, dtype, shape,
contiguity). `repro_torch.kernels.ops` is the entry point that converts
arguments and sends CPU tensors to the plain versions in
`repro_torch.kernels.ref`. ``_build.LAUNCHES`` counts the launches of each
kernel.
"""

from __future__ import annotations

import torch

from ._build import DTYPE_CODE, I, I64, P, Library
from .ref import compute_dtype

__all__ = ["MAX_J", "coded_combine_kernel", "coded_admm_update_kernel"]

MAX_J = 16  # message rows (ECNs) the kernel accepts; kMaxJ in the source

_LIB = Library("coded_combine", {
    "coded_combine_launch": (I, [I, P, P, P, P, I, I, I64, P]),
    "coded_admm_update_launch": (I, [I, P, P, P, P, P, P, P, P, P, I, I, I64, P]),
}, errors="coded_error_string")


def _check(msgs: torch.Tensor, operands) -> None:
    """Validate msgs (R, J, n) and the operands ``operands(R, J, n)``
    returns: a dict name -> (tensor, shape, dtype)."""
    if msgs.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got msgs on {msgs.device}"
        )
    if msgs.dtype not in DTYPE_CODE:
        raise TypeError(
            f"msgs dtype {msgs.dtype} not supported; the kernel is built "
            f"for {sorted(str(d) for d in DTYPE_CODE)}"
        )
    if msgs.dim() != 3 or not msgs.is_contiguous():
        raise ValueError(
            f"msgs must be a contiguous (R, J, n) tensor, got shape "
            f"{tuple(msgs.shape)} contiguous={msgs.is_contiguous()}"
        )
    R, J, n = msgs.shape
    if not (R >= 1 and 1 <= J <= MAX_J and n >= 1):
        raise ValueError(
            f"msgs shape {(R, J, n)} out of range: need R >= 1, "
            f"1 <= J <= {MAX_J}, n >= 1"
        )
    for name, (t, shape, dtype) in operands(R, J, n).items():
        if (
            t.device != msgs.device
            or tuple(t.shape) != shape
            or t.dtype != dtype
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{name}: want a contiguous {shape} {dtype} tensor on "
                f"{msgs.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device} contiguous={t.is_contiguous()}"
            )


def coded_combine_kernel(
    msgs: torch.Tensor, coeffs: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """out (R, n) = sum_j coeffs[:, j] * [mask[:, j] > 0] * msgs[:, j], in
    the accumulation dtype. coeffs and mask in that dtype."""
    ct = compute_dtype(msgs.dtype)
    _check(msgs, lambda R, J, n: dict(
        coeffs=(coeffs, (R, J), ct),
        mask=(mask, (R, J), ct),
    ))
    R, J, n = msgs.shape
    out = torch.empty((R, n), dtype=ct, device=msgs.device)
    _LIB.launch(
        "coded_combine", msgs.device,
        DTYPE_CODE[msgs.dtype], msgs.data_ptr(), coeffs.data_ptr(),
        mask.data_ptr(), out.data_ptr(), R, J, n,
    )
    return out


def coded_admm_update_kernel(
    msgs: torch.Tensor,
    coeffs: torch.Tensor,
    mask: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    tau: torch.Tensor,
    rho: torch.Tensor,
) -> torch.Tensor:
    """Fused decode + eq. (5a) for every run:
    x+ = (tau x + rho z + y - sum_j coeffs[j] [mask[j] > 0] msgs[j]) / (rho + tau).

    x/y/z share msgs' dtype and the output keeps it; coeffs, mask, tau and
    rho are in the accumulation dtype."""
    ct = compute_dtype(msgs.dtype)
    _check(msgs, lambda R, J, n: dict(
        coeffs=(coeffs, (R, J), ct),
        mask=(mask, (R, J), ct),
        x=(x, (R, n), msgs.dtype),
        y=(y, (R, n), msgs.dtype),
        z=(z, (R, n), msgs.dtype),
        tau=(tau, (R,), ct),
        rho=(rho, (R,), ct),
    ))
    R, J, n = msgs.shape
    out = torch.empty_like(x)
    _LIB.launch(
        "coded_admm_update", msgs.device,
        DTYPE_CODE[msgs.dtype], msgs.data_ptr(), coeffs.data_ptr(),
        mask.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        tau.data_ptr(), rho.data_ptr(), out.data_ptr(), R, J, n,
    )
    return out
