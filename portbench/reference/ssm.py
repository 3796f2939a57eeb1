"""Plain float32 reference of the ``ssm`` family: a Mamba-2 language model
(arXiv:2405.21060) with the repo's parameter layout.

Block, pre-norm residual: RMSNorm -> in-projection to (z, x, B, C, dt) ->
causal depthwise convolution of (x, B, C) and SiLU -> dt = softplus(dt +
dt_bias), A = -exp(A_log) -> the SSD scan (one B and C shared by all heads)
-> y + D x -> RMSNorm(y) * SiLU(z) -> out-projection. The embedding is
tied to the head. The scan is the paper's chunked algorithm (its
``ssd_minimal``): the quadratic form within a chunk with decays from
direct segment sums (each sum of log-decays taken over its own steps, so
no difference of two long cumulative sums loses float32 precision), and
the chunk states carried chunk by chunk. Each layer, and the head with
the loss, is recomputed in the backward pass (``checkpoint``) so that the
reference fits beside its inputs at the timed sizes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import const, mm, normal, rmsnorm, row_nll

__all__ = ["SMOKE", "SMOKE_SEQ", "param_spec", "active_params", "attention_flops", "loss"]

# The family's model at a size the CPU tests hold (`portbench.smoke`), and
# the length of its rows there: a multiple of ``ssm_chunk``.
SMOKE = dict(family="ssm", n_layers=2, d_model=128, vocab=512, ssm_state=16, ssm_heads=8,
             ssm_head_dim=32, ssm_expand=2, ssm_chunk=32, conv_width=4,
             tie_embeddings=True, dtype="float32", remat="full")
SMOKE_SEQ = 64


def _dims(m: dict):
    di = m["ssm_expand"] * m["d_model"]
    H, P, N = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"]
    return di, H, P, N, di + 2 * N


def param_spec(m: dict) -> Dict[str, tuple]:
    """name -> (shape, init rule, dtype) in the program's parameter names."""
    D, V, L, W = m["d_model"], m["vocab"], m["n_layers"], m["conv_width"]
    di, H, P, N, conv_dim = _dims(m)
    spec = {"embed": normal((V, D), 0.02), "final_norm": const((D,), 0.0)}
    if not m["tie_embeddings"]:
        spec["lm_head"] = normal((D, V), 0.02)
    for l in range(L):
        p = f"layers.{l}."
        spec.update({
            p + "ln": const((D,), 0.0),
            p + "w_in": normal((D, 2 * di + 2 * N + H), 0.02),
            p + "conv_w": normal((W, conv_dim), 0.2),
            p + "conv_b": const((conv_dim,), 0.0),
            p + "A_log": ((H,), ("log_linspace", 1.0, 16.0), "float32"),
            p + "dt_bias": const((H,), 0.0, "float32"),
            p + "D_skip": const((H,), 1.0, "float32"),
            p + "norm": const((di,), 0.0),
            p + "w_out": normal((di, D), 0.02 / max(L, 1) ** 0.5),
        })
    return spec


def active_params(m: dict) -> int:
    """Parameters that multiply a token: every layer's projections and
    convolution, and the head (the tied embedding, as a product)."""
    D, V, L, W = m["d_model"], m["vocab"], m["n_layers"], m["conv_width"]
    di, H, P, N, conv_dim = _dims(m)
    per = D * (2 * di + 2 * N + H) + W * conv_dim + di * D
    return L * per + D * V


def attention_flops(m: dict, seq: int) -> int:
    """No attention: the SSD's own products are under 0.5% of the
    projections' at these shapes and are not counted."""
    return 0


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < t <= i} a[..., t], -inf above the diagonal."""
    Q = a.shape[-1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=a.device)
    x = a[..., :, None].expand(*a.shape, Q).masked_fill(~torch.tril(ones, -1), 0.0)
    return torch.cumsum(x, dim=-2).masked_fill(~torch.tril(ones), -math.inf)


def ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """y (b, l, h, p) of h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, from a zero state."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of the chunk {chunk}")
    c = l // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    a = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, q)
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)
    Ldec = torch.exp(_segsum(a))  # (b, h, c, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bcij,bhcij,bcjhp->bcihp", scores, Ldec, X)
    # Each chunk's final state from a zero start, then carried across chunks.
    states = torch.einsum("bcjn,bhcj,bcjhp->bchpn", Bc, Ldec[..., -1, :], X)
    within = torch.exp(torch.cumsum(a, dim=-1))  # decay from the chunk's start
    carried = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    off = []
    for k in range(c):
        off.append(torch.einsum("bin,bhpn,bhi->bihp", Cc[:, k], carried, within[:, :, k]))
        carried = carried * within[:, :, k, -1][..., None, None] + states[:, k]
    y = y + torch.stack(off, dim=1)
    return y.reshape(b, l, h, p)


def _layer(m: dict, precision: str, u, ln, w_in, conv_w, conv_b, A_log, dt_bias, D_skip,
           norm, w_out):
    di, H, P, N, conv_dim = _dims(m)
    b, S, _ = u.shape
    h = rmsnorm(u, ln)
    z, xBC, dt_raw = torch.split(mm(h, w_in, precision), [di, conv_dim, H], dim=-1)
    W = conv_w.shape[0]
    xBC = F.conv1d(F.pad(xBC.transpose(1, 2), (W - 1, 0)), conv_w.T[:, None, :],
                   conv_b, groups=conv_dim).transpose(1, 2)
    x, Bm, Cm = torch.split(F.silu(xBC), [di, N, N], dim=-1)
    dt = F.softplus(dt_raw + dt_bias)
    xh = x.reshape(b, S, H, P)
    y = ssd(xh, dt, -torch.exp(A_log), Bm, Cm, m["ssm_chunk"])
    y = (y + D_skip[None, None, :, None] * xh).reshape(b, S, di)
    y = rmsnorm(y, norm) * F.silu(z)
    return u + mm(y, w_out, precision)


_LAYER_KEYS = ("ln", "w_in", "conv_w", "conv_b", "A_log", "dt_bias", "D_skip", "norm", "w_out")


def _head_loss(m, precision, x, final_norm, head, labels, weights):
    logits = mm(rmsnorm(x, final_norm), head, precision)
    return (weights * row_nll(logits, labels)).sum()


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
         row_weights: torch.Tensor, m: dict, precision: str = "float32"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total loss, nll): sum_r w_r * (row r's mean token NLL), float32.
    ``params`` are float32 tensors under the program's names."""
    x = params["embed"][tokens.long()]
    for l in range(m["n_layers"]):
        lp = [params[f"layers.{l}.{k}"] for k in _LAYER_KEYS]
        x = checkpoint(_layer, m, precision, x, *lp, use_reentrant=False)
    head = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    nll = x.new_zeros(())
    for r in range(tokens.shape[0]):  # one row at a time: (S, V) logits
        nll = nll + checkpoint(_head_loss, m, precision, x[r:r + 1], params["final_norm"],
                               head, labels[r:r + 1], row_weights[r:r + 1],
                               use_reentrant=False)
    return nll, nll
