"""Plain PyTorch versions of the kernels (the CPU path and the yardstick
the CUDA kernels are held against).

Counterparts of `repro.kernels.ref`:

- ``coded_combine_ref`` / ``coded_admm_update_ref``, with an explicit
  leading runs axis R in place of the reference's ``vmap``. Same
  semantics, including the accumulation dtype ``promote(dtype, float32)``:
  bf16 and f32 accumulate in f32, f64 stays f64.
- ``flash_attention_ref``: dense attention in the kernel's (B, H, S, hd)
  layout, GQA by head mapping, scores in ``promote(dtype, float32)``
  (float32 for bf16 and f32 inputs), optionally with the rows'
  log-sum-exp; ``flash_attention_bwd_ref`` its gradient from the saved
  output and log-sum-exp, the formulas of the K3 backward kernel.
- ``rglru_scan_ref``: the sequential linear recurrence in
  ``promote(dtype, float32)`` (float32 for the model's float32 gates);
  ``rglru_scan_bwd_ref`` its gradient, the reverse recurrence of the K5
  backward kernel.
- ``causal_conv``: the causal depthwise conv of the Mamba-2 and
  RecurrentGemma layers (float32, float64 for float64, rounded to the
  input's dtype); ``causal_conv_silu_ref``: SiLU of it, the Mamba-2
  mixer's conv + SiLU; ``causal_conv_silu_bwd_ref`` its gradient in
  float64 at the input dtype's rounding points, the closed form of the
  CUDA backward.
- ``ssd_scan_ref``: the sequential Mamba-2 SSD recurrence, in
  ``promote(dtype, float32)`` (the reference computes in float32 and
  raises on float64 ``dt``; float64 here serves the gradient checks);
  ``ssd_chunked`` the chunked form (the model's plain path and prefill,
  and the gradient of K4 outside its tensor-core body);
  ``ssd_scan_bwd_ref`` the gradient of the chunked form, the algebra of
  the K4 backward kernel.

Every one computes in ``compute_dtype`` of its inputs, the one widening
rule of the port's layers and kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "compute_dtype",
    "coded_combine_ref",
    "coded_admm_update_ref",
    "flash_attention_ref",
    "flash_attention_bwd_ref",
    "rglru_scan_ref",
    "rglru_scan_bwd_ref",
    "causal_conv",
    "causal_conv_silu_ref",
    "causal_conv_silu_bwd_ref",
    "ssd_scan_ref",
    "ssd_chunked",
    "ssd_scan_bwd_ref",
]


def compute_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """The type the plain forms, the layers and the kernels compute in:
    ``dtypes`` promoted together and with float32 (float32 for bf16 and
    f32, float64 for float64; the reference widens to float32, and
    float64 serves the f64 checks)."""
    ct = torch.float32
    for dtype in dtypes:
        ct = torch.promote_types(dtype, ct)
    return ct


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


def _band(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int, device):
    """(Sq, Skv) mask of the live (query, key) pairs."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    return mask


def _expand_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, KV, S, hd) -> (B, H, S, hd) by the GQA mapping h -> h * KV // H."""
    return t[:, torch.arange(H, device=t.device) * t.shape[1] // H]


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Skv, hd)
    v: torch.Tensor,  # (B, KV, Skv, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Dense attention with GQA head mapping h -> h * KV // H; scores and
    softmax in ``promote(dtype, float32)``, masked scores -1e30, output in
    q's dtype. With ``return_lse`` also the log-sum-exp of each row's
    scaled scores, (B, H, Sq) in the score dtype: what the kernel's
    forward saves for its backward.

    A query row with no live key gives the mean of v here; the kernel
    gives something else there (ROADMAP Queue 3). Callers keep at least
    one live key per row, as causal self-attention does."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    ct = compute_dtype(q.dtype)
    s = torch.einsum(
        "bhqd,bhkd->bhqk", q.to(ct), _expand_heads(k, H).to(ct)
    ) / math.sqrt(hd)
    mask = _band(Sq, Skv, causal, window, q_offset, q.device)
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _expand_heads(v, H).to(ct)).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Skv, hd)
    v: torch.Tensor,  # (B, KV, Skv, hd)
    o: torch.Tensor,  # (B, H, Sq, hd) the forward's output
    do: torch.Tensor,  # (B, H, Sq, hd) its gradient
    lse: torch.Tensor,  # (B, H, Sq) the forward's row log-sum-exp
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_ref`` (query positions from 0)
    from the saved output and log-sum-exp, in ``promote(dtype, float32)``:

      P  = exp(S - lse) inside the band (0 outside), S = Q K^T / sqrt(hd)
      dV = P^T dO
      dS = P o (dO V^T - rowsum(dO o O))
      dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd)

    and each kv head sums dK and dV over the q_per_kv query heads that
    read it. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    ct = compute_dtype(q.dtype)
    scale = 1.0 / math.sqrt(hd)
    qc, doc = q.to(ct), do.to(ct)
    kx, vx = _expand_heads(k, H).to(ct), _expand_heads(v, H).to(ct)
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kx) * scale
    mask = _band(Sq, Skv, causal, window, 0, q.device)
    p = torch.where(mask[None, None], torch.exp(s - lse.to(ct)[..., None]), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doc)
    dp = torch.einsum("bhqd,bhkd->bhqk", doc, vx)
    delta = (doc * o.to(ct)).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale

    def per_kv(t):  # the query heads of one kv head are consecutive
        return t.reshape(B, KV, H // KV, Skv, hd).sum(2)

    return dq.to(q.dtype), per_kv(dk).to(k.dtype), per_kv(dv).to(v.dtype)


def rglru_scan_ref(
    a: torch.Tensor,  # (B, S, W) decay in (0, 1]
    b: torch.Tensor,  # (B, S, W) input term
    h0: Optional[torch.Tensor] = None,  # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t in ``promote(dtype, float32)``, step by
    step. Returns (h_seq (B, S, W), h_last (B, W)), float32 for float32
    inputs."""
    B, S, W = a.shape
    ct = compute_dtype(a.dtype)
    h = torch.zeros((B, W), dtype=ct, device=a.device) if h0 is None else h0.to(ct)
    hs = torch.empty((B, S, W), dtype=ct, device=a.device)
    for t in range(S):
        h = a[:, t].to(ct) * h + b[:, t].to(ct)
        hs[:, t] = h
    return hs, h


def rglru_scan_bwd_ref(
    a: torch.Tensor,  # (B, S, W)
    h: torch.Tensor,  # (B, S, W) the forward's states
    h0: Optional[torch.Tensor],  # (B, W) or None (zeros)
    dh: torch.Tensor,  # (B, S, W) gradient of h
    dh_last: Optional[torch.Tensor] = None,  # (B, W) gradient of h_last
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``rglru_scan_ref`` by the reverse recurrence, in
    ``promote(dtype, float32)``:

      g_{S-1} = dh_{S-1} + dh_last,   g_t = dh_t + a_{t+1} g_{t+1}
      db_t = g_t,   da_t = g_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 g_0.

    Returns (da, db, dh0)."""
    B, S, W = a.shape
    ct = compute_dtype(a.dtype)
    g = torch.zeros((B, W), dtype=ct, device=a.device) if dh_last is None else dh_last.to(ct)
    prev0 = torch.zeros((B, W), dtype=ct, device=a.device) if h0 is None else h0.to(ct)
    da = torch.empty((B, S, W), dtype=ct, device=a.device)
    db = torch.empty_like(da)
    for t in range(S - 1, -1, -1):
        if t + 1 < S:
            g = a[:, t + 1].to(ct) * g
        g = g + dh[:, t].to(ct)
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1].to(ct) if t > 0 else prev0)
    return da, db, a[:, 0].to(ct) * g


def causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S in float32 (``compute_dtype``): out_t =
    sum_j w_j x_{t-cw+1+j} + b, cast back to ``seq``'s dtype. seq (B, S, C),
    w (cw, C), b (C,)."""
    S = seq.shape[1]
    cw = w.shape[0]
    ct = compute_dtype(seq.dtype)
    pad = F.pad(seq.to(ct), (0, 0, cw - 1, 0))
    wf = w.to(ct)
    out = pad[:, 0:S] * wf[0]
    for j in range(1, cw):
        out = out + pad[:, j:j + S] * wf[j]
    return (out + b.to(ct)).to(seq.dtype)


def causal_conv_silu_ref(
    seq: torch.Tensor,  # (B, S, C)
    w: torch.Tensor,  # (W, C)
    b: torch.Tensor,  # (C,)
) -> torch.Tensor:
    """SiLU(out), out_t = sum_j w_j x_{t-W+1+j} + b (x_t = 0 for t < 0):
    ``F.silu(causal_conv(seq, w, b))``, each product and sum in
    ``promote(dtype, float32)`` in its tap order, rounded to ``seq``'s
    dtype before the SiLU, which the CUDA kernel matches bit for bit.
    Differentiable."""
    return F.silu(causal_conv(seq, w, b))


def causal_conv_silu_bwd_ref(
    seq: torch.Tensor,  # (B, S, C)
    w: torch.Tensor,  # (W, C)
    b: torch.Tensor,  # (C,)
    g: torch.Tensor,  # (B, S, C) gradient of the output
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``causal_conv_silu_ref`` in float64, with the
    rounding points of ``seq``'s dtype (none for float64), as the CUDA
    backward computes it:

      pre_t  = T(sum_j w_j x_{t-W+1+j} + b)               (T: seq's dtype)
      dpre_t = T(g_t s (1 + pre_t (1 - s))), s = sigmoid(pre_t)
      dx_t   = sum_j w_j dpre_{t+W-1-j}  (dpre_t = 0 for t >= S)
      dw_j   = sum_{b,t} dpre_t x_{t-W+1+j},   db = sum_{b,t} dpre_t.

    Returns (dx, dw, db) in float64, unrounded."""
    f64 = torch.float64
    S, W = seq.shape[1], w.shape[0]
    pad = F.pad(seq.to(f64), (0, 0, W - 1, 0))
    wf = w.to(f64)
    pre = sum(pad[:, j:j + S] * wf[j] for j in range(W)) + b.to(f64)
    pre = pre.to(seq.dtype).to(f64)
    s = torch.sigmoid(pre)
    dpre = (g.to(f64) * s * (1 + pre * (1 - s))).to(seq.dtype).to(f64)
    after = F.pad(dpre, (0, 0, 0, W - 1))
    dx = sum(wf[j] * after[:, W - 1 - j:W - 1 - j + S] for j in range(W))
    dw = torch.stack([(dpre * pad[:, j:j + S]).sum((0, 1)) for j in range(W)])
    return dx, dw, dpre.sum((0, 1))


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
    ct = compute_dtype(x.dtype, dt.dtype)
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


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j < t <= i}
    a[..., t], -inf above the diagonal.

    Each entry is summed directly (a cumulative sum down the rows of the
    masked matrix a[t] [t > j]), not as the difference cs[i] - cs[j] of
    one cumulative sum, which is the reference's form. The terms are all
    <= 0, so a direct sum is accurate to its own size; the difference
    loses eps * |cs| to cancellation, and |cs| reaches thousands within a
    256-step chunk of mamba2-1.3b (A down to -16): in float32 a relative
    error of about 1e-4 in every decay factor near the diagonal."""
    Q = a.shape[-1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=a.device)
    terms = a[..., :, None].masked_fill(~torch.tril(tri, diagonal=-1), 0.0)
    seg = torch.cumsum(terms, dim=-2)  # [i, j]: sum of a[t], j < t <= i
    return seg.masked_fill(~torch.tril(tri), -math.inf)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba-2 algorithm): returns (y (B, S, H, P), final
    state (B, H, P, N)) in the compute dtype. Intra-chunk dual quadratic
    form, inter-chunk state carried chunk by chunk; a ragged S is padded
    with dt = 0 steps (decay 1, input 0: identities on the state)."""
    ct = compute_dtype(x.dtype, dt.dtype, A.dtype, Bm.dtype, Cm.dtype)
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    nc = S // Q
    dt = dt.to(ct)
    a = dt * A.to(ct)  # (B, S, H) log-decay per step
    xdt = x.to(ct) * dt[..., None]
    ac = a.reshape(B_, nc, Q, H)
    xc = xdt.reshape(B_, nc, Q, H, P)
    Bc = Bm.to(ct).reshape(B_, nc, Q, N)
    Cc = Cm.to(ct).reshape(B_, nc, Q, N)

    h = torch.zeros((B_, H, P, N), dtype=ct, device=x.device) if h0 is None else h0.to(ct)
    ys = []
    for c in range(nc):
        a_t = ac[:, c].transpose(1, 2)  # (B, H, Q)
        x_, B_in, C_in = xc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(a_t, dim=-1)  # (B, H, Q)
        L = torch.exp(_segsum(a_t))  # (B, H, Q, Q) decay from step j to i
        scores = torch.einsum("bin,bjn->bij", C_in, B_in)  # (B, Q, Q)
        y_intra = torch.einsum("bhij,bjhp->bihp", scores[:, None] * L, x_)
        # carried-in state: y_inter[i] = C_i h * exp(cum_i)
        y_inter = torch.einsum("bin,bhpn->bihp", C_in, h) * torch.exp(cum).transpose(1, 2)[..., None]
        # chunk-final state: h' = h exp(cum_Q) + sum_j exp(cum_Q - cum_j) x_j B_j^T,
        # exp(cum_Q - cum_j) being L's last row
        decay_out = L[..., -1, :]  # (B, H, Q)
        h = h * torch.exp(cum[..., -1])[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", x_ * decay_out.transpose(1, 2)[..., None], B_in
        )
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, S, H, P)
    return y[:, :S_orig], h


def _exclusive_cumsum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """sum of the entries before each one along ``dim`` (0 for the first),
    each a direct sum: no difference of two cumulative sums."""
    head = v.narrow(dim, 0, v.shape[dim] - 1)
    return torch.cat([torch.zeros_like(v.narrow(dim, 0, 1)), torch.cumsum(head, dim)], dim)


def ssd_scan_bwd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    gy: Optional[torch.Tensor],  # (B, S, H, P) gradient of y, or None (zeros)
    gh: Optional[torch.Tensor],  # (B, H, P, N) gradient of h_final, or None
    chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of the chunked SSD scan from a zero state (the function
    of ``ssd_scan_ref`` and ``ssd_chunked``), in
    ``promote(dtype, float32)``, written as the K4 backward kernel computes
    it. Returns (dx, ddt, dA, dBm, dCm).

    Per chunk of Q steps (a ragged S padded with dt = 0 steps), a_t = dt_t A,
    every decay a direct sum of a_t (never a difference of cumulative
    sums): L_ij = exp(sum_{j<t<=i} a_t), g_i = exp(sum_{t<=i} a_t),
    e_j = exp(sum_{t>j} a_t), D = exp(sum_t a_t); s_ij = C_i . B_j.

    - states: h_in of each chunk (forward), and dh_out, the gradient of the
      state leaving each chunk, by the reverse pass dh_out(last) = gh,
      dh_out(c - 1) = D_c dh_out(c) + sum_i g_i gy_i C_i^T;
    - per head, G_ij = gy_i . x_j and F_ij = L_ij dt_j (j <= i);
    - dx_j = dt_j (sum_{i>=j} s_ij L_ij gy_i + e_j dh_out B_j);
    - dS_ij = sum_h F_ij G_ij; dC_i = sum_j dS_ij B_j + sum_h g_i h_in^T gy_i;
      dB_j = sum_i dS_ij C_i + sum_h dt_j e_j dh_out^T x_j;
    - the log-decay gradient da_t = sum_{i>=t, j<t} M_ij (M = s F G)
      + sum_{i>=t} Z_i + sum_{j<t} W_j + Zd, with Z_i = g_i gy_i . h_in C_i,
      W_j = dt_j e_j x_j . dh_out B_j, Zd = D <dh_out, h_in>;
    - ddt_t = A da_t + x_t . (dx_t / dt_t), dA = sum_{b, t} dt_t da_t.
    """
    ct = compute_dtype(x.dtype, dt.dtype)
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    if gy is None:
        gy = torch.zeros((B_, S, H, P), dtype=ct, device=x.device)

    def chunks(t, *tail):  # (B, S, ...) -> (B, nc, Q, ...), zero padded
        t = t.to(ct)
        if pad:
            t = torch.cat([t, t.new_zeros((B_, pad) + tuple(t.shape[2:]))], 1)
        return t.reshape((B_, nc, Q) + tuple(t.shape[2:]))

    xc, gyc = chunks(x), chunks(gy)  # (B, nc, Q, H, P)
    dtc = chunks(dt).transpose(2, 3)  # (B, nc, H, Q)
    Bc, Cc = chunks(Bm), chunks(Cm)  # (B, nc, Q, N)
    A = A.to(ct)
    a = dtc * A[:, None]  # (B, nc, H, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    strict = torch.tril(tri, diagonal=-1)
    # seg[i, j] = sum_{j < t <= i} a_t: a cumulative sum down the rows of
    # a[t] [t > j], as `ssd_chunked`'s _segsum.
    seg = torch.cumsum(a[..., :, None].masked_fill(~strict, 0.0), dim=-2)
    L = torch.exp(seg).masked_fill(~tri, 0.0)  # (B, nc, H, Q, Q)
    g = torch.exp(torch.cumsum(a, -1))  # (B, nc, H, Q)
    e = torch.exp(torch.flip(_exclusive_cumsum(torch.flip(a, [-1]), -1), [-1]))
    D = torch.exp(a.sum(-1))  # (B, nc, H)
    s = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B, nc, Q, Q)

    # Chunk-entry states, forward; state gradients, backward.
    w = dtc * e  # dt_j e_j
    h = torch.zeros((B_, H, P, N), dtype=ct, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = D[:, c, :, None, None] * h + torch.einsum(
            "bhj,bjhp,bjn->bhpn", w[:, c], xc[:, c], Bc[:, c])
    dh = torch.zeros_like(h) if gh is None else gh.to(ct)
    dh_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        dh_out[c] = dh
        dh = D[:, c, :, None, None] * dh + torch.einsum(
            "bhi,bihp,bin->bhpn", g[:, c], gyc[:, c], Cc[:, c])
    h_in = torch.stack(h_in, 1)  # (B, nc, H, P, N)
    dh_out = torch.stack(dh_out, 1)

    G = torch.einsum("bcihp,bcjhp->bchij", gyc, xc)
    F = L * dtc[..., None, :]  # L_ij dt_j
    M = s[:, :, None] * F * G
    dS = (F * G).sum(2)  # (B, nc, Q, Q)
    q = torch.einsum("bchpn,bcjn->bcjhp", dh_out, Bc)  # dh_out B_j
    intra = torch.einsum("bcij,bchij,bcihp->bcjhp", s, L, gyc)
    dxhat = intra + e.transpose(2, 3)[..., None] * q
    dx = dtc.transpose(2, 3)[..., None] * dxhat
    ddt_direct = (xc * dxhat).sum(-1)  # (B, nc, Q, H)
    v = torch.einsum("bchpn,bcihp->bcihn", h_in, gyc)  # h_in^T gy_i
    dC = (torch.einsum("bcij,bcjn->bcin", dS, Bc)
          + torch.einsum("bchi,bcihn->bcin", g, v))
    r = torch.einsum("bchpn,bcjhp->bcjhn", dh_out, xc)  # dh_out^T x_j
    dB = (torch.einsum("bcij,bcin->bcjn", dS, Cc)
          + torch.einsum("bchj,bcjhn->bcjn", w, r))
    Z = g.transpose(2, 3) * torch.einsum("bcihn,bcin->bcih", v, Cc)
    W = w.transpose(2, 3) * torch.einsum("bcjhn,bcjn->bcjh", r, Bc)
    Zd = D * torch.einsum("bchpn,bchpn->bch", dh_out, h_in)
    # da_t = sum_{i >= t} sum_{j < t} M_ij: each row's sums before t, then
    # the rows at or after t.
    before = _exclusive_cumsum(M, -1)  # [i, t] = sum_{j < t} M_ij
    da_intra = before.masked_fill(~tri, 0.0).sum(-2)  # over i >= t
    da_inter = torch.flip(torch.cumsum(torch.flip(Z, [2]), 2), [2])  # over i >= t
    da_state = _exclusive_cumsum(W, 2)  # over j < t
    da = da_intra.transpose(2, 3) + da_inter + da_state + Zd[:, :, None]  # (B, nc, Q, H)
    ddt = A * da + ddt_direct
    dA = (dtc.transpose(2, 3) * da).sum((0, 1, 2))

    def unchunk(t):
        return t.reshape((B_, nc * Q) + tuple(t.shape[3:]))[:, :S]

    return unchunk(dx), unchunk(ddt), dA, unchunk(dB), unchunk(dC)
