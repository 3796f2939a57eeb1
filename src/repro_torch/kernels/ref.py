"""Plain PyTorch versions of the kernels (the CPU path and the yardstick
the CUDA kernels are held against).

Counterparts of `repro.kernels.ref`:

- ``coded_combine_ref`` / ``coded_admm_update_ref``, with an explicit
  leading runs axis R in place of the reference's ``vmap``. Same
  semantics, including the accumulation dtype ``promote(dtype, float32)``:
  bf16 and f32 accumulate in f32, f64 stays f64.
- ``flash_attention_ref``: dense attention in the kernel's (B, H, S, hd)
  layout, GQA by head mapping, float32 scores.
- ``rglru_scan_ref``: the sequential linear recurrence in float32.
- ``ssd_scan_ref``: the sequential Mamba-2 SSD recurrence, in
  ``promote(dtype, float32)`` (the reference computes in float32 and
  raises on float64 ``dt``; float64 here serves the gradient checks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "compute_dtype",
    "coded_combine_ref",
    "coded_admm_update_ref",
    "flash_attention_ref",
    "rglru_scan_ref",
    "ssd_scan_ref",
]


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


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Skv, hd)
    v: torch.Tensor,  # (B, KV, Skv, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Dense attention with GQA head mapping h -> h * KV // H; scores and
    softmax in float32, masked scores -1e30, output in q's dtype.

    A query row with no live key gives the mean of v here; the kernel
    gives something else there (ROADMAP Queue 3). Callers keep at least
    one live key per row, as causal self-attention does."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    kv_idx = torch.arange(H, device=q.device) * KV // H
    kx = k[:, kv_idx]  # (B, H, Skv, hd)
    vx = v[:, kv_idx]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) / torch.sqrt(
        torch.tensor(float(hd))
    ).item()
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    return o.to(q.dtype)


def rglru_scan_ref(
    a: torch.Tensor,  # (B, S, W) decay in (0, 1]
    b: torch.Tensor,  # (B, S, W) input term
    h0: Optional[torch.Tensor] = None,  # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t in float32, step by step. Returns
    (h_seq (B, S, W) f32, h_last (B, W) f32)."""
    B, S, W = a.shape
    h = (
        torch.zeros((B, W), dtype=torch.float32, device=a.device)
        if h0 is None
        else h0.float()
    )
    hs = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        hs[:, t] = h
    return hs, h


def ssd_scan_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence step by step (its mathematical definition):

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T ;  y_t = h_t C_t,

    in ``promote(dtype, float32)`` of the inputs. Returns (y (B, S, H, P),
    h_final (B, H, P, N)). Differentiable (no in-place writes)."""
    ct = compute_dtype(torch.promote_types(x.dtype, dt.dtype))
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (
        torch.zeros((B_, H, P, N), dtype=ct, device=x.device)
        if h0 is None
        else h0.to(ct)
    )
    A = A.to(ct)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(ct)  # (B, H)
        a = torch.exp(dt_t[:, :, None, None] * A[None, :, None, None])
        xdt = x[:, t].to(ct) * dt_t[:, :, None]
        h = a * h + xdt[..., None] * Bm[:, t].to(ct)[:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].to(ct)))
    return torch.stack(ys, dim=1), h
