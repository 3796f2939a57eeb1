"""Public entry points of the kernels, dispatched by device.

Counterpart of `repro.kernels.ops`. A CUDA tensor goes to the
hand-written kernel or the call raises; a CPU tensor goes to the plain
PyTorch version (`repro_torch.kernels.ref`); any other device raises.
There is no fallback from one to the other. ``flash_attention``,
``rglru_scan`` and ``ssd_scan`` are differentiable on the card through
autograd Functions (`_FlashAttention` and `_RGLRUScan`, whose backward is
a hand-written kernel; `_SSDScan`, whose backward is plain PyTorch); on
the CPU the plain versions run under ordinary autograd. The coded-combine
kernels have no backward (nothing differentiates them).

Unlike the reference, nothing is padded or re-tiled: the TPU kernels need
128-lane tiles and block sizes that divide the sequence (hence
``fit_block_n``, ``_pad_to`` and the block halving there), while the CUDA
kernels mask their own ragged edges. The coded-combine shapes carry an
explicit runs axis: msgs (R, J, n), coeffs/mask (R, J), x/y/z (R, n),
tau/rho (R,).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .coded_combine import coded_admm_update_kernel, coded_combine_kernel
from .flash_attention import flash_attention_bwd_kernel, flash_attention_kernel
from .ref import (
    coded_admm_update_ref,
    coded_combine_ref,
    compute_dtype,
    flash_attention_ref,
    rglru_scan_ref,
    ssd_scan_ref,
)
from .rglru_scan import rglru_scan_bwd_kernel, rglru_scan_kernel
from .ssd_scan import ssd_body, ssd_scan_kernel, ssd_scan_tc_kernel

__all__ = [
    "coded_combine",
    "coded_admm_update",
    "flash_attention",
    "rglru_scan",
    "ssd_scan",
]


def _on_cuda(t: torch.Tensor, what: str = "coded-combine") -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} path for device {t.device}")


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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


class _FlashAttention(torch.autograd.Function):
    """K3 with a gradient, on CUDA tensors: the forward kernel (which also
    writes each row's log-sum-exp) and the backward kernel, from the saved
    q, k, v, output and log-sum-exp. Query positions start at 0."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_kernel(
            q, k, v, causal=causal, window=window, return_lse=True
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal, window=ctx.window
        )
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd) — model layout
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention in the model's (B, S, H, hd) layout, GQA-aware
    (query head h reads kv head h * KV // H). Query positions are
    ``arange(Sq) + q_offset``; every query row must keep at least one live
    key (ROADMAP Queue 3). Output in q's dtype. Differentiable: on CUDA
    through the backward kernel (query positions from 0 only), on the CPU
    through the plain version."""
    if not _on_cuda(q, "flash-attention"):
        out = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset,
        )
        return out.transpose(1, 2)
    if _needs_grad(q, k, v):
        if q_offset:
            raise ValueError(
                "the K3 backward kernel takes query positions from 0 "
                f"(training); got q_offset={q_offset} on inputs that need a gradient"
            )
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(),
        causal=causal, window=window, q_offset=q_offset,
    )


class _RGLRUScan(torch.autograd.Function):
    """K5 with a gradient, on CUDA tensors: the forward kernel, and the
    reverse-scan backward kernel from the saved a, h and h0. A gradient is
    computed only for the inputs that need one (h0's, the backward's dh0,
    only when h0 needs it); b's gradient is the scan's g, which the kernel
    writes anyway."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = rglru_scan_kernel(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        need = ctx.needs_input_grad
        da, db, dh0 = rglru_scan_bwd_kernel(
            a, h, h0, dh.contiguous(), dh_last.contiguous(), want_dh0=need[2]
        )
        return (da if need[0] else None, db if need[1] else None, dh0)


def rglru_scan(
    a: torch.Tensor,  # (B, S, W)
    b: torch.Tensor,  # (B, S, W)
    h0: Optional[torch.Tensor] = None,  # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence h_t = a_t h_{t-1} + b_t (RG-LRU inner scan) in
    float32 from h0 (zeros when None). Returns (h (B, S, W), h_last (B, W)).
    Differentiable: on CUDA through the backward kernel, on the CPU
    through the plain version."""
    if not _on_cuda(a, "rglru-scan"):
        return rglru_scan_ref(a, b, h0)
    f32 = [t.to(torch.float32).contiguous() for t in (a, b)]
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    if _needs_grad(a, b, h0):
        return _RGLRUScan.apply(*f32, h0)
    return rglru_scan_kernel(*f32, h0)


class _SSDScan(torch.autograd.Function):
    """K4 with a gradient. The forward is the CUDA kernel for CUDA tensors,
    in the body that `ssd_body` picks from the inputs (the tensor-core body
    for bfloat16 at P = 64, N = 128, a chunk in ``TC_CHUNKS`` and 16-byte
    aligned x/Bm/Cm; the CUDA-core body otherwise), and the sequential
    plain version for CPU tensors. The backward is plain
    PyTorch on both devices: the JAX package has no backward kernel for
    its SSD scan (nothing there defines a custom VJP, and the reference
    trains through ``ssd_chunked``), so the backward recomputes the port's
    ``ssd_chunked`` from the saved inputs under autograd and returns its
    gradients — what the reference's trained path differentiates. A
    backward kernel is ROADMAP Queue 2 work."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        if x.device.type == "cuda":
            xc, Bc, Cc = x.contiguous(), Bm.contiguous(), Cm.contiguous()
            tc = ssd_body(xc, Bc, Cc, chunk) == "tensor_cores"
            y, h = (ssd_scan_tc_kernel if tc else ssd_scan_kernel)(
                xc, dt.to(torch.float32).contiguous(), A.to(torch.float32).contiguous(),
                Bc, Cc, chunk,
            )
        else:
            y, h = ssd_scan_ref(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models.mamba2 import ssd_chunked

        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [
                t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)
            ]
            y, h = ssd_chunked(*leaves, ctx.chunk)
            # An output whose gradient is None (unused) is left out; then an
            # input may be unused too (h_final does not depend on Cm).
            pairs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t in leaves if t.requires_grad],
                [g for _, g in pairs], allow_unused=True,
            ))
        return (*(next(grads) if n else None for n in need), None)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state: (y (B, S, H, P), h_final
    (B, H, P, N)). On CUDA: the kernel (x, Bm, Cm of one dtype, float32 or
    bfloat16; float32 outputs; a ragged S masked in the kernel, as the
    reference's dt = 0 padding), in the body `ssd_body` picks. On the CPU:
    the sequential plain version. Differentiable on both (`_SSDScan`)."""
    _on_cuda(x, "ssd-scan")
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
