"""The plain twins of the K3, K4 and K5 backward kernels, on the CPU.

``flash_attention_bwd_ref``, ``ssd_scan_bwd_ref`` and
``rglru_scan_bwd_ref`` (`repro_torch.kernels.ref`) are the formulas the
backward kernels compute, and what the card holds them against (tests/
test_torch_kernels_gpu.py, chip_smoke.py). Here they are held, at float64
within 1e-10 normwise, against torch autograd of the port's forward twins
(for K4, the port's ``ssd_chunked``: the JAX package has no gradient of
its own scan but autograd of its jnp path) and K3's and K5's against
``jax.vjp`` of the reference's oracles
(`repro.kernels.ref.flash_attention_ref`, ``rglru_scan_ref``; those cast
to float32, so they run with their module's ``jnp`` replaced by a view of
``jax.numpy`` whose ``float32`` is ``float64``). Cases: GQA, MQA, a window
shorter than S, ragged lengths, an initial state h0 and a gradient of
h_last. And on the CPU the differentiable entry points of `ops` send
inputs that need a gradient through the plain versions under autograd,
launching nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as r_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models.mamba2 import ssd_chunked

TOL = 1e-10


class _Jnp64:
    """``jax.numpy`` with its ``float32`` name bound to ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def reference_in_f64(monkeypatch):
    monkeypatch.setattr(r_ref, "jnp", _Jnp64())


def _normwise(got, want) -> float:
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach().numpy() if isinstance(want, torch.Tensor) else want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, H, KV, S, hd, causal, window): GQA; MQA with a window shorter than S;
# a ragged S with GQA 4:1 and a window; non-causal.
FA_CASES = [
    (2, 4, 2, 24, 16, True, None),
    (1, 4, 1, 40, 32, True, 9),
    (2, 8, 2, 37, 8, True, 16),
    (1, 2, 1, 20, 16, False, None),
]


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", FA_CASES)
def test_flash_attention_bwd_ref_matches_autograd_and_jax_vjp(
    reference_in_f64, B, H, KV, S, hd, causal, window
):
    rng = np.random.default_rng(S * H + hd)
    qn = rng.standard_normal((B, H, S, hd))
    kn, vn = (rng.standard_normal((B, KV, S, hd)) for _ in range(2))
    don = rng.standard_normal((B, H, S, hd))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    do = torch.from_numpy(don)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(
        q.detach(), k.detach(), v.detach(), o.detach(), do, lse.detach(), causal, window
    )
    o_r, vjp = jax.vjp(
        lambda q_, k_, v_: r_ref.flash_attention_ref(q_, k_, v_, causal=causal, window=window),
        *(jnp.asarray(a) for a in (qn, kn, vn)),
    )
    assert o_r.dtype == jnp.float64
    assert _normwise(o, np.asarray(o_r)) <= TOL
    want_r = vjp(jnp.asarray(don))
    for name, g, w, wr in zip("qkv", got, want, want_r):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        assert _normwise(g, w) <= TOL, name
        assert _normwise(g, np.asarray(wr)) <= TOL, name


@pytest.mark.parametrize("with_h0,with_dlast", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("B,S,W", [(2, 37, 8), (1, 64, 5)])
def test_rglru_scan_bwd_ref_matches_autograd_and_jax_vjp(reference_in_f64, B, S, W, with_h0, with_dlast):
    rng = np.random.default_rng(S * W)
    an = rng.uniform(0.2, 1.0, (B, S, W))
    bn = rng.standard_normal((B, S, W))
    h0n = rng.standard_normal((B, W))
    dhn = rng.standard_normal((B, S, W))
    dln = rng.standard_normal((B, W)) if with_dlast else np.zeros((B, W))
    a, b, h0 = (torch.from_numpy(x).requires_grad_(True) for x in (an, bn, h0n))
    h, h_last = ref.rglru_scan_ref(a, b, h0 if with_h0 else None)
    assert h.dtype == torch.float64
    dh, dl = torch.from_numpy(dhn), torch.from_numpy(dln)
    inputs = (a, b, h0) if with_h0 else (a, b)
    want = torch.autograd.grad((h, h_last), inputs, (dh, dl))
    got = ref.rglru_scan_bwd_ref(
        a.detach(), h.detach(), h0.detach() if with_h0 else None, dh,
        dl if with_dlast else None,
    )
    jin = [jnp.asarray(x) for x in ((an, bn, h0n) if with_h0 else (an, bn))]
    _, vjp = jax.vjp(lambda *xs: r_ref.rglru_scan_ref(*xs), *jin)
    want_r = vjp((jnp.asarray(dhn), jnp.asarray(dln)))
    for name, g, w, wr in zip(("a", "b", "h0"), got, want, want_r):
        assert _normwise(g, w) <= TOL, name
        assert _normwise(g, np.asarray(wr)) <= TOL, name


# (B, S, H, P, N, chunk): a ragged S over three chunks, an even S of two
# chunks, S shorter than one chunk, a single whole chunk.
SSD_CASES = [(2, 37, 3, 4, 5, 16), (1, 32, 2, 3, 4, 16), (2, 7, 2, 2, 3, 8), (1, 16, 1, 4, 2, 16)]


@pytest.mark.parametrize("with_gy,with_gh", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_bwd_ref_matches_autograd_of_ssd_chunked(B, S, H, P, N, chunk, with_gy, with_gh):
    """The K4 backward's algebra (chunked, the reverse state pass, direct
    segment sums) against autograd of ``ssd_chunked`` in float64, with the
    gradient of y, of the final state, or of both; head 0 decays at
    A = -16, mamba2-1.3b's fastest."""
    rng = np.random.default_rng(S * H + chunk)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    A = -np.exp(rng.standard_normal(H))
    A[0] = -16.0
    Bm, Cm = rng.standard_normal((2, B, S, N))
    gy = torch.from_numpy(rng.standard_normal((B, S, H, P))) if with_gy else None
    gh = torch.from_numpy(rng.standard_normal((B, H, P, N))) if with_gh else None
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, A, Bm, Cm)]
    y, h = ssd_chunked(*leaves, chunk)
    pairs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
    want = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                               allow_unused=True)
    got = ref.ssd_scan_bwd_ref(*(t.detach() for t in leaves), gy, gh, chunk)
    for name, g, w, t in zip(("x", "dt", "A", "Bm", "Cm"), got, want, leaves):
        assert g.dtype == torch.float64 and g.shape == t.shape, name
        w = torch.zeros_like(g) if w is None else w  # h_final does not depend on Cm
        assert float((g - w).abs().max()) <= TOL * max(float(w.abs().max()), 1.0), name


def test_differentiable_entry_points_run_plain_autograd_on_the_cpu():
    """On CPU tensors that need a gradient, ops.flash_attention and
    ops.rglru_scan differentiate their plain versions (no kernel, no
    launch); the gradients are the twins'."""
    rng = np.random.default_rng(0)
    before = dict(LAUNCHES)
    q = torch.from_numpy(rng.standard_normal((1, 12, 4, 16))).requires_grad_(True)
    kv = torch.from_numpy(rng.standard_normal((2, 1, 12, 2, 16))).requires_grad_(True)
    out = ops.flash_attention(q, kv[0], kv[1], causal=True, window=5)
    do = torch.from_numpy(rng.standard_normal(out.shape))
    dq, dkv = torch.autograd.grad(out, (q, kv), do)
    t = lambda x: x.detach().transpose(1, 2)  # noqa: E731
    o, lse = ref.flash_attention_ref(t(q), t(kv[0]), t(kv[1]), True, 5, return_lse=True)
    want = ref.flash_attention_bwd_ref(t(q), t(kv[0]), t(kv[1]), o, t(do), lse, True, 5)
    assert _normwise(dq, want[0].transpose(1, 2)) <= TOL
    assert _normwise(dkv[0], want[1].transpose(1, 2)) <= TOL
    assert _normwise(dkv[1], want[2].transpose(1, 2)) <= TOL

    a = torch.from_numpy(rng.uniform(0.3, 1.0, (2, 9, 3))).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((2, 9, 3))).requires_grad_(True)
    h, h_last = ops.rglru_scan(a, b)
    dh = torch.from_numpy(rng.standard_normal(h.shape))
    da, db = torch.autograd.grad((h * dh).sum() + h_last.sum(), (a, b))
    want = ref.rglru_scan_bwd_ref(a.detach(), h.detach(), None, dh, torch.ones_like(h_last))
    assert _normwise(da, want[0]) <= TOL and _normwise(db, want[1]) <= TOL
    assert LAUNCHES == before
