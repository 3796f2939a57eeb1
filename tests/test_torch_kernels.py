"""The port's kernels against the reference's.

On the CPU the port's `ops` send tensors to the plain PyTorch versions
(`repro_torch.kernels.ref`); these are held against `repro.kernels.ref`
(the pure-jnp oracles) and `repro.kernels.ops` (the Pallas kernels, in
interpret mode on the CPU) on the same numpy-seeded inputs, over the case
grids of ``tests/test_kernels.py``. Tolerances: 1e-12 in f64 (the
reference's own f64 parity bound), 1e-5 in f32 and 2e-2 in bf16 (its
f32/bf16 kernel tolerances). f64 runs on the x64 switch set by
``tests/conftest.py``. The CUDA kernels themselves are compared with the
plain versions on the card in ``tests/test_torch_kernels_gpu.py``.

Flash attention (K3) and the RG-LRU scan (K5) are held the same way:
``ops.flash_attention`` and ``ref.flash_attention_ref`` against
`repro.kernels.ops.flash_attention` (Pallas, interpret mode, small
blocks) and its oracle over GQA, MQA, a sliding window, a query offset
that leaves every row a live key, and ragged lengths; ``ops.rglru_scan``
against `repro.kernels.ops.rglru_scan` with and without h0. Tolerances:
float32 attention 1e-5 (scores and softmax in f32 on both sides, other
summation orders); bf16 attention 2e-2 (a few bf16 ulps of the bf16
output); the scan 1e-6 * S normwise (the reference's doubling scan and
the port's step-by-step loop round differently, error growing with S).

The SSD scan (K4): ``ops.ssd_scan`` (on the CPU: the sequential plain
version) and ``ref.ssd_scan_ref`` against `repro.kernels.ref.ssd_scan_ref`
and `repro.kernels.ops.ssd_scan` (Pallas, interpret mode) over the grid of
``tests/test_kernels.py`` (including the padded S = 200), at the reference's
TOL in f32 and bf16. In f64 against the oracle at 1e-12: the oracle casts to
float32 (and its scan carry raises on float64 ``dt``), so it runs with its
module's ``jnp`` replaced by a view whose ``float32`` is ``float64``; no
file of `repro` changes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels._build import LAUNCHES
from repro_torch.kernels.coded_combine import coded_admm_update_kernel, coded_combine_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.rglru_scan import rglru_scan_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_kernel

TOL = {
    "float32": dict(rtol=1e-5, atol=1e-5),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float64": dict(rtol=1e-12, atol=1e-12),
}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}
TORCH = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype`` (bf16
    rounds from float32 to nearest even in both frameworks)."""
    src = a.astype(np.float64 if dtype == "float64" else np.float32)
    return jnp.asarray(src).astype(JNP[dtype]), torch.from_numpy(src).to(
        TORCH[dtype]
    )


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


def _inputs(J, n, dtype, seed, coeff_dtype=None):
    rng = np.random.default_rng(seed)
    msgs = _pair(rng.standard_normal((J, n)), dtype)
    coeffs = _pair(rng.standard_normal(J), coeff_dtype or
                   ("float64" if dtype == "float64" else "float32"))
    xyz = [_pair(rng.standard_normal(n), dtype) for _ in range(3)]
    return msgs, coeffs, xyz


@pytest.mark.parametrize("J,n", [(3, 4096), (5, 5000), (16, 12_288), (2, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_matches_reference(J, n, dtype):
    (jm, tm), (jc, tc), _ = _inputs(J, n, dtype, J * n)
    out = t_ops.coded_combine(tm[None], tc[None])[0]
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(r_ref.coded_combine_ref(jm, jc)), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(r_ops.coded_combine(jm, jc)), **TOL[dtype])


@pytest.mark.parametrize("J,n", [(3, 4096), (4, 9999)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_reference(J, n, dtype):
    (jm, tm), (jc, tc), xyz = _inputs(J, n, dtype, J + n)
    (jx, tx), (jy, ty), (jz, tz) = xyz
    tau, rho = 2.5, 1.0
    out = t_ops.coded_admm_update(
        tm[None], tc[None], tx[None], ty[None], tz[None],
        torch.tensor([tau]), torch.tensor([rho]),
    )[0]
    assert out.dtype == tx.dtype
    jtau = jnp.asarray(tau, jnp.float32)
    for want in (
        r_ref.coded_admm_update_ref(jm, jc, jx, jy, jz, jtau, rho),
        r_ops.coded_admm_update(jm, jc, jx, jy, jz, jtau, rho),
    ):
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_mask_parity(dtype):
    """Masked decode patterns (deadline truncation), as in the reference's
    mask parity test."""
    J, n = 6, 5000
    (jm, tm), (jc, tc), ((jx, tx), (jy, ty), (jz, tz)) = _inputs(J, n, dtype, 17)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    out = t_ops.coded_admm_update(
        tm[None], tc[None], tx[None], ty[None], tz[None],
        torch.tensor([1.3]), torch.tensor([0.9]), torch.from_numpy(mask)[None],
    )[0]
    jtau, jmask = jnp.asarray(1.3, jnp.float32), jnp.asarray(mask)
    for want in (
        r_ref.coded_admm_update_ref(jm, jc, jx, jy, jz, jtau, 0.9, jmask),
        r_ops.coded_admm_update(jm, jc, jx, jy, jz, jtau, 0.9, jmask),
    ):
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


def test_f64_parity_at_1e12():
    """f64 end to end at the reference's f64 bound (x64 from conftest)."""
    J, n = 5, 3000
    (jm, tm), (jc, tc), ((jx, tx), (jy, ty), (jz, tz)) = _inputs(J, n, "float64", 7)
    mask = np.array([1.0, 1.0, 0.0, 1.0, 1.0])
    assert jm.dtype == jnp.float64
    out_c = t_ops.coded_combine(tm[None], tc[None], torch.from_numpy(mask)[None])[0]
    assert out_c.dtype == torch.float64
    for want in (
        r_ref.coded_combine_ref(jm, jc, jnp.asarray(mask)),
        r_ops.coded_combine(jm, jc, jnp.asarray(mask)),
    ):
        np.testing.assert_allclose(_np(out_c), _np(want), **TOL["float64"])
    out_u = t_ops.coded_admm_update(
        tm[None], tc[None], tx[None], ty[None], tz[None],
        torch.tensor([2.2], dtype=torch.float64),
        torch.tensor([0.7], dtype=torch.float64), torch.from_numpy(mask)[None],
    )[0]
    assert out_u.dtype == torch.float64
    jtau = jnp.asarray(2.2)
    for want in (
        r_ref.coded_admm_update_ref(jm, jc, jx, jy, jz, jtau, 0.7, jnp.asarray(mask)),
        r_ops.coded_admm_update(jm, jc, jx, jy, jz, jtau, 0.7, jnp.asarray(mask)),
    ):
        np.testing.assert_allclose(_np(out_u), _np(want), **TOL["float64"])


def test_runs_axis_matches_per_run_reference():
    """R > 1: every run has its own messages, coefficients, mask, tau and
    rho; run r of the port equals the reference called on run r alone."""
    R, J, n = 4, 6, 640
    rng = np.random.default_rng(11)
    msgs = rng.standard_normal((R, J, n))
    coeffs = rng.standard_normal((R, J))
    mask = (rng.random((R, J)) > 0.3).astype(np.float64)
    x, y, z = (rng.standard_normal((R, n)) for _ in range(3))
    tau = rng.random(R) * 3 + 0.5
    rho = rng.random(R) + 0.5
    t = [torch.from_numpy(a) for a in (msgs, coeffs, x, y, z, tau, rho, mask)]
    out_u = t_ops.coded_admm_update(*t)
    out_c = t_ops.coded_combine(t[0], t[1], t[7])
    for r in range(R):
        np.testing.assert_allclose(
            _np(out_u[r]),
            _np(r_ref.coded_admm_update_ref(
                jnp.asarray(msgs[r]), jnp.asarray(coeffs[r]), jnp.asarray(x[r]),
                jnp.asarray(y[r]), jnp.asarray(z[r]), jnp.asarray(tau[r]),
                float(rho[r]), jnp.asarray(mask[r]),
            )),
            **TOL["float64"],
        )
        np.testing.assert_allclose(
            _np(out_c[r]),
            _np(r_ref.coded_combine_ref(
                jnp.asarray(msgs[r]), jnp.asarray(coeffs[r]), jnp.asarray(mask[r])
            )),
            **TOL["float64"],
        )


def test_nan_in_dead_rows_cannot_leak():
    """NaN planted in masked-out message rows never reaches the decoded
    combine (the reference's test_async guarantee), in either package."""
    rng = np.random.default_rng(0)
    msgs = rng.normal(size=(6, 64)).astype(np.float32)
    coeffs = rng.normal(size=6).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], dtype=np.float32)
    poisoned = msgs.copy()
    poisoned[mask == 0] = np.nan
    tmask = torch.from_numpy(mask)[None]
    clean = t_ops.coded_combine(torch.from_numpy(msgs)[None], torch.from_numpy(coeffs)[None], tmask)
    out = t_ops.coded_combine(
        torch.from_numpy(poisoned)[None], torch.from_numpy(coeffs)[None], tmask
    )
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)
    want = r_ops.coded_combine(poisoned, coeffs, mask)
    np.testing.assert_allclose(_np(out[0]), _np(want), **TOL["float32"])
    ones = torch.ones(1, 64)
    upd = t_ops.coded_admm_update(
        torch.from_numpy(poisoned)[None], torch.from_numpy(coeffs)[None],
        ones, ones, ones, torch.tensor([1.0]), torch.tensor([1.0]), tmask,
    )
    assert torch.isfinite(upd).all()


def test_cpu_tensors_take_the_plain_version():
    """On a CPU tensor `ops` is exactly the plain version and launches no
    kernel; the kernel wrappers refuse CPU tensors; other devices raise."""
    rng = np.random.default_rng(3)
    m = torch.from_numpy(rng.standard_normal((2, 3, 50)))
    c = torch.from_numpy(rng.standard_normal((2, 3)))
    x, y, z = (torch.from_numpy(rng.standard_normal((2, 50))) for _ in range(3))
    tau, rho = torch.tensor([1.5, 2.0], dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    before = dict(LAUNCHES)
    assert torch.equal(t_ops.coded_combine(m, c), t_ref.coded_combine_ref(m, c, torch.ones(2, 3)))
    assert torch.equal(
        t_ops.coded_admm_update(m, c, x, y, z, tau, rho),
        t_ref.coded_admm_update_ref(m, c, x, y, z, tau, rho, torch.ones(2, 3)),
    )
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        coded_combine_kernel(m, c, torch.ones(2, 3))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        coded_admm_update_kernel(m, c, torch.ones(2, 3), x, y, z, tau, rho)
    with pytest.raises(ValueError, match="no coded-combine path"):
        t_ops.coded_combine(m.to("meta"), c.to("meta"))



# ---- flash attention (K3) -------------------------------------------------

# (B, H, KV, Sq, Skv, hd, window, q_offset): GQA, MQA with a window, a
# query offset into a longer key sequence (every query sees its own key),
# ragged lengths, and a window wider than the sequence.
FA_CASES = [
    (2, 4, 2, 32, 32, 32, None, 0),
    (1, 4, 1, 48, 48, 64, 16, 0),
    (2, 2, 2, 16, 48, 32, None, 32),
    (1, 4, 2, 37, 37, 32, 9, 0),
    (1, 2, 1, 24, 40, 64, 12, 16),
    (1, 8, 2, 40, 40, 16, 100, 0),
]
FA_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(B, H, KV, Sq, Skv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, Sq, H, hd)), dtype)
    k = _pair(rng.standard_normal((B, Skv, KV, hd)), dtype)
    v = _pair(rng.standard_normal((B, Skv, KV, hd)), dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,window,q_offset", FA_CASES)
def test_flash_attention_matches_reference(B, H, KV, Sq, Skv, hd, window, q_offset, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, H, KV, Sq, Skv, hd, dtype, Sq * H + Skv)
    before = dict(LAUNCHES)
    out = t_ops.flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    assert LAUNCHES == before  # CPU tensors: the plain version
    assert out.shape == (B, Sq, H, hd) and out.dtype == TORCH[dtype]
    ref = t_ref.flash_attention_ref(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        causal=True, window=window, q_offset=q_offset,
    )
    assert torch.equal(out, ref.transpose(1, 2))
    want_ops = r_ops.flash_attention(
        jq, jk, jv, causal=True, window=window, q_offset=q_offset, block_q=8, block_kv=8,
    )
    want_ref = r_ref.flash_attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3),
        causal=True, window=window, q_offset=q_offset,
    ).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(want_ops), **FA_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(want_ref), **FA_TOL[dtype])


def test_flash_attention_non_causal_and_f32_scores_from_bf16():
    """Non-causal attention; and bf16 inputs give the f32-scored result
    rounded once (what a bf16-accumulating kernel would miss)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 1, 20, 28, 32, "float32", 5)
    out = t_ops.flash_attention(tq, tk, tv, causal=False)
    want = r_ops.flash_attention(jq, jk, jv, causal=False, block_q=4, block_kv=4)
    np.testing.assert_allclose(_np(out), _np(want), **FA_TOL["float32"])
    out16 = t_ops.flash_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), causal=True)
    want16 = t_ops.flash_attention(
        tq.bfloat16().float(), tk.bfloat16().float(), tv.bfloat16().float(), causal=True
    ).bfloat16()
    assert torch.equal(out16, want16)


# ---- RG-LRU scan (K5) -----------------------------------------------------


def _scan_inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, (B, S, W)).astype(np.float32)  # decays in (0, 1]
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(2, 64, 128), (1, 37, 48), (3, 256, 16)])
def test_rglru_scan_matches_reference(B, S, W, with_h0):
    a, b, h0 = _scan_inputs(B, S, W, S * W)
    th0 = torch.from_numpy(h0) if with_h0 else None
    before = dict(LAUNCHES)
    h, h_last = t_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), th0)
    assert LAUNCHES == before
    assert h.shape == (B, S, W) and h_last.shape == (B, W)
    assert h.dtype == h_last.dtype == torch.float32
    assert torch.equal(h[:, -1], h_last)
    jh0 = jnp.asarray(h0) if with_h0 else None
    wh, wlast = r_ops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, block_s=16, block_w=16)
    rh, rlast = r_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)
    tol = 1e-6 * S
    for got, want in ((h, wh), (h_last, wlast), (h, rh), (h_last, rlast)):
        gap = np.abs(_np(got) - _np(want)).max()
        assert gap <= tol * max(np.abs(_np(want)).max(), 1.0), gap


def test_new_kernel_wrappers_refuse_cpu_and_other_devices():
    t = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_kernel(t, t, t)
    a = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rglru_scan_kernel(a, a)
    with pytest.raises(ValueError, match="no flash-attention path"):
        t_ops.flash_attention(t.to("meta"), t.to("meta"), t.to("meta"))
    with pytest.raises(ValueError, match="no rglru-scan path"):
        t_ops.rglru_scan(a.to("meta"), a.to("meta"))


def test_k3_and_k5_refuse_inputs_that_need_a_gradient():
    """The raw launchers record no gradient (the backward kernels run only
    through the autograd Functions of `ops`): under grad mode an input
    that requires a gradient raises (before any launch), instead of an
    output that would silently drop the gradient. Without grad mode the
    device check runs."""
    t = torch.zeros(1, 8, 2, 64)
    q = t.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="records no gradient.*ops.flash_attention"):
        flash_attention_kernel(q, t, t)
    a = torch.zeros(1, 8, 4)
    with pytest.raises(RuntimeError, match="records no gradient.*ops.rglru_scan"):
        rglru_scan_kernel(a, a, torch.zeros(1, 4, requires_grad=True))
    with torch.no_grad():
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            flash_attention_kernel(q, t, t)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            rglru_scan_kernel(a.requires_grad_(True), a)


# ---- SSD scan (K4) ---------------------------------------------------------


class _Jnp64:
    """``jax.numpy`` with its ``float32`` name bound to ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _ssd_inputs(B, S, H, P, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((B, S, H, P)), dtype)
    f = "float64" if dtype == "float64" else "float32"
    dt = _pair(np.log1p(np.exp(rng.standard_normal((B, S, H)))), f)
    A = _pair(-np.exp(rng.standard_normal(H)), f)
    Bm = _pair(rng.standard_normal((B, S, N)) / np.sqrt(N), dtype)
    Cm = _pair(rng.standard_normal((B, S, N)) / np.sqrt(N), dtype)
    return [p[0] for p in (x, dt, A, Bm, Cm)], [p[1] for p in (x, dt, A, Bm, Cm)]


SSD_CASES = [
    (1, 128, 2, 16, 32, 64),
    (2, 256, 4, 32, 64, 128),
    (1, 200, 2, 16, 32, 64),  # padded path (S not a chunk multiple)
]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_reference(B, S, H, P, N, chunk, dtype):
    jx, tx = _ssd_inputs(B, S, H, P, N, dtype, S * H)
    before = dict(LAUNCHES)
    y, h = t_ops.ssd_scan(*tx, chunk=chunk)
    ry, rh = t_ref.ssd_scan_ref(*tx)
    assert LAUNCHES == before  # CPU tensors: the plain version
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    wy, wh = r_ops.ssd_scan(*jx, chunk=chunk)
    oy, oh = r_ref.ssd_scan_ref(*jx)
    for got, want in ((y, wy), (h, wh), (y, oy), (h, oh)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_f64_matches_oracle(monkeypatch, B, S, H, P, N, chunk):
    monkeypatch.setattr(r_ref, "jnp", _Jnp64())
    jx, tx = _ssd_inputs(B, S, H, P, N, "float64", S + H)
    y, h = t_ops.ssd_scan(*tx, chunk=chunk)
    oy, oh = r_ref.ssd_scan_ref(*jx)
    assert y.dtype == h.dtype == torch.float64
    np.testing.assert_allclose(_np(y), _np(oy), **TOL["float64"])
    np.testing.assert_allclose(_np(h), _np(oh), **TOL["float64"])


@pytest.mark.parametrize("S,chunk", [(256, 64), (200, 64), (45, 32)])
def test_ssd_chunked_matches_reference_chunked(S, chunk):
    """The port's plain chunked form (the gradient's path and the plain
    model path) against the reference's, float32, with and without an
    initial state: the reference's f32 TOL."""
    from repro.models.mamba2 import ssd_chunked as r_chunked
    from repro_torch.models.mamba2 import ssd_chunked

    B, H, P, N = 2, 4, 8, 16
    jx, tx = _ssd_inputs(B, S, H, P, N, "float32", S)
    h0 = np.random.default_rng(1).standard_normal((B, H, P, N)).astype(np.float32)
    for j0, t0 in ((None, None), (jnp.asarray(h0), torch.from_numpy(h0))):
        y, h = ssd_chunked(*tx, chunk, t0)
        wy, wh = r_chunked(*jx, chunk, j0)
        np.testing.assert_allclose(_np(y), _np(wy), **TOL["float32"])
        np.testing.assert_allclose(_np(h), _np(wh), **TOL["float32"])


def test_ssd_scan_kernel_wrapper_refuses_cpu_and_other_devices():
    _, (x, dt, A, Bm, Cm) = _ssd_inputs(1, 8, 2, 4, 8, "float32", 0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_scan_kernel(x, dt, A, Bm, Cm, 4)
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    with pytest.raises(ValueError, match="no ssd-scan path"):
        t_ops.ssd_scan(*meta, chunk=4)


def _at_odd_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


def test_ssd_scan_tc_kernel_refuses_what_its_body_does_not_take():
    """The tensor-core body's wrapper raises before any launch: another
    dtype, P, N or chunk than mamba2-1.3b's bf16 heads, x/Bm/Cm off a
    16-byte boundary (its 16-byte loads would fault on the card), and,
    those met, CPU tensors."""
    from repro_torch.kernels.ssd_scan import ssd_scan_tc_kernel

    before = dict(LAUNCHES)
    _, good = _ssd_inputs(1, 64, 2, 64, 128, "bfloat16", 0)
    _, f32 = _ssd_inputs(1, 64, 2, 64, 128, "float32", 0)
    _, narrow_p = _ssd_inputs(1, 64, 2, 32, 128, "bfloat16", 0)
    _, narrow_n = _ssd_inputs(1, 64, 2, 64, 64, "bfloat16", 0)
    for args, chunk in ((f32, 64), (narrow_p, 64), (narrow_n, 64), (good, 32), (good, 512)):
        with pytest.raises(ValueError, match="tensor-core body takes"):
            ssd_scan_tc_kernel(*args, chunk)
    for i, name in ((0, "x"), (3, "Bm"), (4, "Cm")):
        args = list(good)
        args[i] = _at_odd_offset(args[i])
        assert args[i].is_contiguous() and args[i].data_ptr() % 16
        with pytest.raises(ValueError, match=f"{name} on a 16-byte boundary"):
            ssd_scan_tc_kernel(*args, 64)
    for chunk in (64, 128, 256):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ssd_scan_tc_kernel(*good, chunk)
    assert LAUNCHES == before


def test_build_key_follows_included_headers_and_per_source_flags(tmp_path, monkeypatch):
    """The library's hash changes when a local header that the source
    includes (directly or through another header) or one of its flags
    changes, and not when an unrelated file does; nvcc is not needed."""
    from repro_torch.kernels import _build

    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/a.cuh"\nint f();\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("#pragma once\nint g();\n")
    (tmp_path / "other.cuh").write_text("int h();\n")
    flags = _build.NVCC_FLAGS
    assert [p.name for p in _build.local_headers(src)] == ["a.cuh", "b.cuh"]
    key = _build.build_key(src, flags)
    assert _build.build_key(src, flags) == key
    (tmp_path / "other.cuh").write_text("int h2();\n")
    assert _build.build_key(src, flags) == key
    (tmp_path / "inc" / "b.cuh").write_text("#pragma once\nint g2();\n")
    key_b = _build.build_key(src, flags)
    assert key_b != key
    assert _build.build_key(src, (*flags, "-I/usr/local/cutlass/include")) != key_b
    assert _build.build_key(src, (*flags, "-lcuda")) != key_b
    # The package's own sources: K3 includes the sm90 header, and a flag
    # added for K3 alone moves K3's key and no other source's.
    k3 = _build.CSRC / "flash_attention.cu"
    assert [p.name for p in _build.local_headers(k3)] == ["sm90.cuh"]
    before = {n: _build.build_key(_build.CSRC / f"{n}.cu", _build.flags(n))
              for n in ("flash_attention", "coded_combine")}
    monkeypatch.setitem(_build.EXTRA_FLAGS, "flash_attention", ("-lcuda",))
    assert _build.flags("flash_attention")[-1] == "-lcuda"
    after = {n: _build.build_key(_build.CSRC / f"{n}.cu", _build.flags(n))
             for n in before}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["coded_combine"] == before["coded_combine"]


# ---- K4's split operands and K5's chunk pairs: the CUDA designs' arithmetic


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float64)


def _split(v: torch.Tensor, parts: int) -> torch.Tensor:
    """What a product sees of a float operand fed to bf16 tensor cores in
    ``parts`` bf16 pieces: hi = bf16(v), lo = bf16(v - hi), ..."""
    out = torch.zeros_like(v)
    for _ in range(parts):
        piece = _bf16(v - out)
        out = out + piece
    return out


def _ssd_tc_emulation(x, dt, A, Bm, Cm, Q, parts):
    """K4's tensor-core body in float64 arithmetic, except that the float
    side of each product is rounded as the kernel rounds it (``_split``):
    the masked, decayed, dt-scaled scores of the intra-chunk term, w B of
    the chunk state, and h_in of the inter-chunk term. x, B and C are
    bf16 values, used exactly."""
    Bn, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bn, H, N, P), dtype=torch.float64)  # h^T, as the kernel
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        Bc, Cc = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        q = xc.shape[1]
        a = dtc * A  # (B, q, H)
        cum = torch.cumsum(a, dim=1)  # (B, q, H)
        # exp(sum_{j < t <= i} a_t) for j <= i: in f64 the difference of
        # cumulative sums is exact to far below what is tested.
        seg = (cum[:, :, None] - cum[:, None, :]).permute(0, 3, 1, 2)  # (B, H, i, j)
        causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
        L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)
        M = scores[:, None] * L * dtc.permute(0, 2, 1)[:, :, None, :]  # (B, H, i, j)
        y = torch.einsum("bhij,bjhp->bihp", _split(M, parts), xc)
        y += torch.einsum("bin,bhnp->bihp", Cc, _split(h, parts)) * torch.exp(cum)[..., None]
        rest = a.sum(1, keepdim=True) - cum  # sum_{t > j}
        w = dtc * torch.exp(rest)  # (B, q, H)
        wB = _split(w.permute(0, 2, 1)[..., None] * Bc[:, None], parts)  # (B, H, j, n)
        h = h * torch.exp(a.sum(1))[..., None, None] + torch.einsum("bhjn,bjhp->bhnp", wB, xc)
        ys.append(y)
    return torch.cat(ys, 1), h.transpose(-1, -2)


@pytest.mark.parametrize(
    "parts,bound,within", [(1, 1e-5, False), (2, 1e-5, True), (3, 1e-7, True)]
)
def test_ssd_split_operands_meet_the_kernel_tolerance(parts, bound, within):
    """K4's tensor-core body feeds the float side of each product to the
    bf16 tensor cores in pieces. At mamba2-1.3b's chunk (Q 256, P 64,
    N 128) over S = 1024 with a head at A = -16, against the exact f64
    recurrence: one bf16 rounding misses the card's 1e-5 (chip_smoke's
    SSD_EXACT_TOL); hi + lo meets it; the kernel's three parts come within
    1e-7, so the split adds nothing beyond float32 round-off."""
    rng = np.random.default_rng(15)
    B, S, H, P, N, Q = 1, 1024, 2, 64, 128, 256
    x = _bf16(torch.from_numpy(rng.standard_normal((B, S, H, P))))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, H))))).float().double()
    A = torch.tensor([-16.0, -float(np.exp(rng.standard_normal()))], dtype=torch.float64)
    Bm, Cm = (_bf16(torch.from_numpy(rng.standard_normal((B, S, N)) / np.sqrt(N)))
              for _ in range(2))
    want_y, want_h = t_ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    y, h = _ssd_tc_emulation(x, dt, A, Bm, Cm, Q, parts)
    scale = lambda t: max(t.abs().max().item(), 1.0)  # noqa: E731
    gap = max((y - want_y).abs().max().item() / scale(want_y),
              (h - want_h).abs().max().item() / scale(want_h))
    assert (gap <= bound) == within, gap


def _rglru_chained(a, b, h0, chunk, lookback):
    """K5's chained scan in plain PyTorch: each chunk of ``chunk`` steps
    reduced to the pair (prod a, h from 0); the state entering chunk k
    composed from the chunks before it, as the kernel's look-back does
    when it finds chunk k - 1's inclusive state ("nearest") or has to
    compose every aggregate back to chunk 0 ("deepest"); then the
    recurrence over the chunk from that state."""
    B, S, W = a.shape
    starts = list(range(0, S, chunk))
    pairs, inclusive, hs = [], [], []
    for k, t0 in enumerate(starts):
        ak, bk = a[:, t0:t0 + chunk], b[:, t0:t0 + chunk]
        prod, loc = torch.ones(B, W), torch.zeros(B, W)
        for u in range(ak.shape[1]):
            loc = ak[:, u] * loc + bk[:, u]
            prod = prod * ak[:, u]
        pairs.append((prod, loc))
        if k == 0:
            carry = h0 if h0 is not None else torch.zeros(B, W)
        else:
            pa, pb = torch.ones(B, W), torch.zeros(B, W)
            j = k - 1
            while lookback == "deepest" and j > 0:
                pb = pa * pairs[j][1] + pb
                pa = pa * pairs[j][0]
                j -= 1
            carry = pa * inclusive[j] + pb
        inclusive.append(prod * carry + loc)
        for u in range(ak.shape[1]):
            carry = ak[:, u] * carry + bk[:, u]
            hs.append(carry)
    return torch.stack(hs, 1), hs[-1]


@pytest.mark.parametrize("lookback", ["nearest", "deepest"])
@pytest.mark.parametrize("S,with_h0", [(1000, False), (2049, True), (64, True)])
def test_rglru_chunk_pairs_match_reference(S, with_h0, lookback):
    """K5's chunk-pair composition at the kernel's chunking (CHUNK_STEPS),
    S ragged or not, against `repro.kernels.ref.rglru_scan_ref`, float32,
    at chip_smoke's SCAN_TOL of 1e-5 normwise."""
    from repro_torch.kernels.rglru_scan import CHUNK_STEPS

    B, W = 2, 48
    a, b, h0 = _scan_inputs(B, S, W, S + W)
    th0 = torch.from_numpy(h0) if with_h0 else None
    h, h_last = _rglru_chained(torch.from_numpy(a), torch.from_numpy(b), th0, CHUNK_STEPS, lookback)
    jh0 = jnp.asarray(h0) if with_h0 else None
    wh, wlast = r_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)
    for got, want in ((h, wh), (h_last, wlast)):
        gap = np.abs(_np(got) - _np(want)).max()
        assert gap <= 1e-5 * max(np.abs(_np(want)).max(), 1.0), gap
