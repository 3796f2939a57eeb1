"""The port's CUDA kernels (K1-K5) against their plain PyTorch versions,
on a card.

Marked ``gpu``: each test skips without a CUDA device (the kernels have no
CPU or interpret mode). This file imports neither JAX nor `repro`, so it
runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest configures JAX.) Tolerances are
the reference's kernel-test levels, by output dtype: 1e-12 in f64, 1e-5
in f32, 2e-2 in bf16 (only the update's bf16-rounded output; the combine
of bf16 messages returns f32 and is held at f32 round-off). The SSD scan
(K4) is held normwise (max |kernel - plain| <= tol * max(max |plain|, 1))
against the sequential recurrence run in float64 on the same input values
(the exact answer), at 1e-5 for float32 and bf16 inputs alike: the kernel
reads bf16 exactly and computes in float32, so only its float32 round-off
shows (a float32 plain version would add its own, growing with S). Its
float32 gradient (the CUDA-core domain) is held against autograd of the
plain ``ssd_chunked`` at 1e-6; its bf16 gradient, the backward kernel's,
against float64 autograd of ``ssd_chunked`` on the same bf16 values (see
SSD_BWD_FACTOR).
The backward kernels of K3 and K5 are held against their plain twins
(``flash_attention_bwd_ref``, ``rglru_scan_bwd_ref``) at the levels
stated beside each test.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels._build import LAUNCHES

TOL = {
    "float32": dict(rtol=1e-5, atol=1e-5),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float64": dict(rtol=1e-12, atol=1e-12),
}
TORCH = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``offset`` elements into
    its buffer: offset 1 misaligns the base for 16-byte vector loads."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize(
    "R,J,n,offset",
    [
        (16, 6, 3, 0),  # fig5's step: n below every vector width
        (9, 3, 640, 0),  # USPS width: vectors in every dtype
        (3, 16, 5001, 0),  # ragged n, J at its maximum
        (4, 1, 22, 0),  # J = 1; ijcnn1's n = 22, not a multiple of 4 or 8
        (6, 1, 640, 0),  # J = 1 with vectors
        (5, 16, 4096, 0),  # J = 16 with vectors
        (3, 3, 640, 1),  # a misaligned base pointer: the scalar instance
        (4, 16, 5001, 1),  # misaligned and ragged
    ],
)
def test_cuda_kernels_match_plain_version(cuda, dtype, R, J, n, offset):
    """On the card: kernel == plain version (same tolerances), NaN in dead
    rows dropped (row 0 of every run when J > 1, and every row of the last
    run), launch counters advance by one per call."""
    dt = TORCH[dtype]
    ct = t_ref.compute_dtype(dt)
    g = torch.Generator(device="cpu").manual_seed(R * J * n + offset)
    msgs = torch.randn(R, J, n, generator=g).to(dt)
    coeffs = torch.randn(R, J, generator=g).to(ct)
    mask = (torch.rand(R, J, generator=g) > 0.3).float()
    if J > 1:
        mask[:, 0] = 0.0
        msgs[:, 0] = float("nan")
    mask[-1] = 0.0  # a run whose rows are all dead ...
    msgs[-1] = float("nan")  # ... and poisoned
    x, y, z = (torch.randn(R, n, generator=g).to(dt) for _ in range(3))
    tau = torch.rand(R, generator=g).to(ct) + 0.5
    rho = torch.rand(R, generator=g).to(ct) + 0.5
    cpu_args = (msgs, coeffs, x, y, z, tau, rho, mask)
    dev_args = tuple(a.to(cuda) for a in cpu_args)
    if offset:
        dev_args = tuple(
            _at_offset(a, offset) if i in (0, 2, 3, 4) else a
            for i, a in enumerate(dev_args)
        )
        assert dev_args[0].data_ptr() % 16 != 0
    before = dict(LAUNCHES)
    got_u = t_ops.coded_admm_update(*dev_args)
    got_c = t_ops.coded_combine(dev_args[0], dev_args[1], dev_args[7])
    torch.cuda.synchronize()
    assert LAUNCHES["coded_admm_update"] == before["coded_admm_update"] + 1
    assert LAUNCHES["coded_combine"] == before["coded_combine"] + 1
    want_u = t_ref.coded_admm_update_ref(*dev_args)
    want_c = t_ref.coded_combine_ref(dev_args[0], dev_args[1], dev_args[7])
    assert got_u.dtype == dt and got_c.dtype == ct
    assert torch.isfinite(got_u).all() and torch.isfinite(got_c).all()
    assert (got_c[-1] == 0).all()  # nothing alive: G = 0
    np.testing.assert_allclose(_np(got_u), _np(want_u), **TOL[dtype])
    np.testing.assert_allclose(
        _np(got_c), _np(want_c), **TOL[str(ct).removeprefix("torch.")]
    )


FA_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Skv,hd,window,q_offset",
    [
        (2, 16, 8, 256, 256, 128, None, 0),  # qwen3 heads
        (1, 16, 1, 200, 200, 256, 64, 0),  # recurrentgemma MQA, window
        (2, 4, 2, 67, 131, 64, None, 64),  # ragged, offset into the keys
        (1, 8, 8, 100, 100, 128, 1, 0),  # window 1: the diagonal only
        # The bf16 tensor-core body's edges (128-query tiles; 128-key tiles,
        # 64 at hd 256):
        (1, 4, 2, 1000, 1000, 64, None, 0),  # ragged Sq = Skv, q_per_kv 2
        (1, 4, 2, 1000, 1000, 128, None, 0),
        (1, 2, 1, 1000, 1000, 256, None, 0),  # MQA
        (2, 4, 2, 67, 131, 128, None, 64),  # ragged, offset, Skv > Sq
        (2, 4, 1, 67, 131, 256, None, 64),
        (1, 16, 1, 256, 256, 128, None, 0),  # MQA at hd 128
        (1, 4, 4, 300, 300, 128, 40, 0),  # window under one key tile
        (1, 4, 1, 300, 300, 256, 40, 0),
        (2, 8, 4, 200, 520, 64, 100, 320),  # offset, window, Skv > Sq
    ],
)
def test_flash_attention_kernel_matches_plain_version(
    cuda, dtype, B, H, KV, Sq, Skv, hd, window, q_offset
):

    g = torch.Generator(device="cpu").manual_seed(Sq * hd)
    q = torch.randn(B, Sq, H, hd, generator=g).to(TORCH[dtype]).to(cuda)
    k = torch.randn(B, Skv, KV, hd, generator=g).to(TORCH[dtype]).to(cuda)
    v = torch.randn(B, Skv, KV, hd, generator=g).to(TORCH[dtype]).to(cuda)
    before = LAUNCHES["flash_attention"]
    got = t_ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = t_ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_offset=q_offset,
    ).transpose(1, 2)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), **FA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize(
    "B,S,W",
    [
        (2, 512, 4096),
        (1, 1000, 300),
        (2, 2048, 4096),  # the recurrentgemma-9b prefill step
        (1, 2049, 300),  # one step past a multiple of the chunk
        (2, 33, 129),  # two chunks, the second one step; a ragged channel tile
        (1, 5, 1),  # one chunk shorter than the chunk length, one channel
    ],
)
def test_rglru_scan_kernel_matches_plain_version(cuda, B, S, W, with_h0):

    g = torch.Generator(device="cpu").manual_seed(S + W)
    a = (torch.rand(B, S, W, generator=g) * 0.8 + 0.2).to(cuda)
    b = torch.randn(B, S, W, generator=g).to(cuda)
    h0 = torch.randn(B, W, generator=g).to(cuda) if with_h0 else None
    before = LAUNCHES["rglru_scan"]
    h, h_last = t_ops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    want_h, want_last = t_ref.rglru_scan_ref(a, b, h0)
    # Same sequential recurrence; only FMA contraction differs.
    np.testing.assert_allclose(_np(h), _np(want_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h_last), _np(want_last), rtol=1e-5, atol=1e-5)


SSD_TOL = 1e-5


def _normwise(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(want.double().abs().max().item(), 1.0)
    return (got.double() - want.double()).abs().max().item() / scale


def _ssd_inputs(B, S, H, P, N, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed + S * H)
    x = torch.randn(B, S, H, P, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g))
    Bm = (torch.randn(B, S, N, generator=g) / N**0.5).to(dtype)
    Cm = (torch.randn(B, S, N, generator=g) / N**0.5).to(dtype)
    return [t.to(device) for t in (x, dt, A, Bm, Cm)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (2, 1024, 8, 64, 128, 256),  # mamba2-1.3b heads, 4 chunks
        (1, 1000, 4, 64, 128, 256),  # ragged S: the last chunk is partial
        (2, 96, 8, 32, 16, 32),  # the mamba2 smoke config
        (1, 200, 2, 16, 32, 64),  # small, ragged
    ],
)
def test_ssd_scan_kernel_matches_plain_version(cuda, dtype, B, S, H, P, N, chunk):
    from repro_torch.kernels.ssd_scan import ssd_body

    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, TORCH[dtype], cuda)
    # The body the rule picks launches once, the other not at all.
    key = {"tensor_cores": "ssd_scan_tc", "cuda_cores": "ssd_scan"}[ssd_body(x, Bm, Cm, chunk)]
    before = dict(LAUNCHES)
    y, h = t_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, **{key: before[key] + 1})
    want_y, want_h = t_ref.ssd_scan_ref(*(t.double() for t in (x, dt, A, Bm, Cm)))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert _normwise(y, want_y) <= SSD_TOL
    assert _normwise(h, want_h) <= SSD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("S", [1024, 1000, 77])
def test_ssd_scan_tensor_core_body_matches_exact_answer(cuda, S, chunk):
    """The bf16 tensor-core body (P 64, N 128) at each of its chunks, S a
    multiple of every chunk, ragged, and shorter than one chunk, with head
    0 at A = -16 (mamba2-1.3b's fastest decay): within SSD_TOL of the
    exact f64 recurrence, that head alone too."""
    from repro_torch.kernels.ssd_scan import ssd_scan_tc_kernel

    x, dt, A, Bm, Cm = _ssd_inputs(2, S, 4, 64, 128, torch.bfloat16, cuda, seed=chunk)
    A[0] = -16.0
    before = dict(LAUNCHES)
    y, h = ssd_scan_tc_kernel(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, ssd_scan_tc=before["ssd_scan_tc"] + 1)
    want_y, want_h = t_ref.ssd_scan_ref(*(t.double() for t in (x, dt, A, Bm, Cm)))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert _normwise(y, want_y) <= SSD_TOL
    assert _normwise(h, want_h) <= SSD_TOL
    assert _normwise(y[:, :, 0], want_y[:, :, 0]) <= SSD_TOL
    assert _normwise(h[:, 0], want_h[:, 0]) <= SSD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["x", "Bm", "Cm"])
def test_ssd_scan_tensor_core_body_refuses_a_misaligned_view(cuda, operand):
    """A contiguous view one element past a 16-byte boundary raises
    ValueError before the launch, and the context stays usable: the same
    values at an aligned address then meet the exact answer."""
    from repro_torch.kernels.ssd_scan import ssd_scan_tc_kernel

    args = dict(zip(("x", "dt", "A", "Bm", "Cm"),
                    _ssd_inputs(1, 300, 2, 64, 128, torch.bfloat16, cuda)))
    view = _at_offset(args[operand], 1)
    assert view.is_contiguous() and view.data_ptr() % 16
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ssd_scan_tc_kernel(**dict(args, **{operand: view}), chunk=128)
    assert LAUNCHES == before
    y, h = ssd_scan_tc_kernel(**dict(args, **{operand: view.clone()}), chunk=128)
    torch.cuda.synchronize()
    want_y, want_h = t_ref.ssd_scan_ref(*(args[k].double() for k in ("x", "dt", "A", "Bm", "Cm")))
    assert _normwise(y, want_y) <= SSD_TOL
    assert _normwise(h, want_h) <= SSD_TOL


@pytest.mark.gpu
def test_ssd_scan_gradient_on_the_card_is_autograd_of_ssd_chunked(cuda):
    from repro_torch.models.mamba2 import ssd_chunked

    inputs = _ssd_inputs(2, 300, 4, 64, 128, torch.float32, cuda, seed=5)
    a = [t.clone().requires_grad_(True) for t in inputs]
    b = [t.clone().requires_grad_(True) for t in inputs]
    g = torch.Generator(device="cpu").manual_seed(9)
    gy = torch.randn(2, 300, 4, 64, generator=g).to(cuda)
    gh = torch.randn(2, 4, 64, 128, generator=g).to(cuda)
    y, h = t_ops.ssd_scan(*a, chunk=128)
    torch.autograd.backward([y, h], [gy, gh])
    y2, h2 = ssd_chunked(*b, 128)
    torch.autograd.backward([y2, h2], [gy, gh])
    for name, ta, tb in zip(("x", "dt", "A", "Bm", "Cm"), a, b):
        assert ta.grad is not None and torch.isfinite(ta.grad).all(), name
        assert _normwise(ta.grad, tb.grad) <= 1e-6, name


@pytest.mark.gpu
def test_ssd_scan_bf16_training_runs_the_tensor_cores_and_autograd_of_ssd_chunked(cuda):
    """mamba2-1.3b's heads in bf16 (P 64, N 128, chunk 256): `ops.ssd_scan`
    launches the tensor-core body once and the CUDA-core body never, its
    forward is within SSD_TOL of the exact answer, and its gradient, the
    backward kernel's (launched once), is as close to float64 autograd of
    the plain ``ssd_chunked`` on the same inputs as float32 autograd of it
    (SSD_BWD_FACTOR), each in its input's dtype."""
    from repro_torch.kernels.ssd_scan import ssd_body

    inputs = _ssd_inputs(2, 600, 4, 64, 128, torch.bfloat16, cuda, seed=7)
    assert ssd_body(inputs[0], inputs[3], inputs[4], 256) == "tensor_cores"
    a = [t.clone().requires_grad_(True) for t in inputs]
    g = torch.Generator(device="cpu").manual_seed(11)
    gy = torch.randn(2, 600, 4, 64, generator=g).to(cuda)
    gh = torch.randn(2, 4, 64, 128, generator=g).to(cuda)
    before = dict(LAUNCHES)
    y, h = t_ops.ssd_scan(*a, chunk=256)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, ssd_scan_tc=before["ssd_scan_tc"] + 1)
    want_y, want_h = t_ref.ssd_scan_ref(*(t.double() for t in inputs))
    assert _normwise(y, want_y) <= SSD_TOL and _normwise(h, want_h) <= SSD_TOL
    torch.autograd.backward([y, h], [gy, gh])
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, ssd_scan_tc=before["ssd_scan_tc"] + 1,
                       ssd_scan_bwd_tc=before["ssd_scan_bwd_tc"] + 1)
    assert [t.grad.dtype for t in a] == [t.dtype for t in inputs]
    gaps, _ = _ssd_bwd_gaps([t.grad for t in a], inputs, gy, gh, 256)
    for name, (kernel, chunked) in gaps.items():
        assert kernel <= SSD_BWD_FACTOR * chunked, (name, kernel, chunked)


# The backward kernel's gradients against float64 autograd of ssd_chunked on
# the same bf16 values, each no farther from it than SSD_BWD_FACTOR x the
# gap of autograd of float32 ssd_chunked (the path it replaces, twice over
# for another summation order):
# - dx, dBm and dCm as returned (bf16, as autograd of ssd_chunked returns
#   them too) case by case, and the kernel's float32 sums of them
#   (grad_dtype float32) within SSD_BWD_F32_TOL normwise: float32 round-off
#   of a chunk's sums, as the forward (the card read 1.2e-7 to 4.1e-7,
#   float32 ssd_chunked 1.4e-7 to 4.4e-7);
# - ddt and dA (float32) by the worst gap over all the cases: a case's gap
#   of these sums over whole sequences is float32 noise of either path (over
#   48 cases on the card, dA's median gap 1.8e-7 against ssd_chunked's 2.5e-7,
#   the worst 5.0e-6 against 4.9e-6 where both lose digits to cancellation,
#   yet one case in seven had the kernel beyond 2 x ssd_chunked's gap, and
#   as many the other way).
SSD_BWD_FACTOR = 2.0
SSD_BWD_F32_TOL = 1e-6
SSD_GRADS = ("x", "dt", "A", "Bm", "Cm")
SSD_BWD_CASES = [(chunk, S, with_gh) for chunk in (64, 128, 256) for S in (1024, 600)
                 for with_gh in (True, False)]


def _rel(got, want) -> float:
    return (got.double() - want.double()).abs().max().item() / max(
        want.double().abs().max().item(), 1e-30)


def _chunked_grads(inputs, gy, gh, chunk, dtype):
    from repro_torch.models.mamba2 import ssd_chunked

    leaves = [t.to(dtype).requires_grad_(True) for t in inputs]
    y, h = ssd_chunked(*leaves, chunk)
    pairs = [(y, gy)] + ([(h, gh)] if gh is not None else [])
    grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                [g.to(dtype) for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g.to(t.dtype) for g, t in zip(grads, inputs)]


def _ssd_bwd_gaps(got, inputs, gy, gh, chunk):
    """({name: (gap of ``got``, gap of float32 ssd_chunked's gradient)} to
    float64 autograd of ssd_chunked, each gradient in its input's dtype;
    the float64 gradients)."""
    exact = _chunked_grads([t.double() for t in inputs], gy, gh, chunk, torch.float64)
    f32 = _chunked_grads(inputs, gy, gh, chunk, torch.float32)
    gaps = {n: (_rel(g, e), _rel(c, e)) for n, g, c, e in zip(SSD_GRADS, got, f32, exact)}
    return gaps, exact


def _ssd_bwd_case(cuda, chunk, S, with_gh):
    """mamba2-1.3b's heads (P 64, N 128) at B 2, H 4, head 0 at A = -16,
    and output gradients: (inputs, gy, gh)."""
    inputs = _ssd_inputs(2, S, 4, 64, 128, torch.bfloat16, cuda, seed=chunk + int(with_gh))
    inputs[2][0] = -16.0
    g = torch.Generator(device="cpu").manual_seed(S + chunk)
    gy = torch.randn(2, S, 4, 64, generator=g).to(cuda)
    gh = torch.randn(2, 4, 64, 128, generator=g).to(cuda) if with_gh else None
    return inputs, gy, gh


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,S,with_gh", SSD_BWD_CASES)
def test_ssd_scan_backward_kernel_matches_float64(cuda, chunk, S, with_gh):
    """S a multiple of every chunk or ragged, with and without a gradient of
    the final state: dx, dBm and dCm against float64 autograd of
    ``ssd_chunked`` (module note), as returned and as float32 sums; every
    gradient finite and in its input's dtype; the same bits on a second run;
    one launch counted a call."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_tc_kernel

    inputs, gy, gh = _ssd_bwd_case(cuda, chunk, S, with_gh)
    before = dict(LAUNCHES)
    got = ssd_scan_bwd_tc_kernel(*inputs, gy, gh, chunk)
    again = ssd_scan_bwd_tc_kernel(*inputs, gy, gh, chunk)
    sums = ssd_scan_bwd_tc_kernel(*inputs, gy, gh, chunk, torch.float32)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, ssd_scan_bwd_tc=before["ssd_scan_bwd_tc"] + 3)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert [t.dtype for t in got] == [t.dtype for t in inputs]
    assert all(torch.isfinite(t).all() for t in (*got, *sums))
    gaps, exact = _ssd_bwd_gaps(got, inputs, gy, gh, chunk)
    for i, name in ((0, "x"), (3, "Bm"), (4, "Cm")):
        kernel, chunked = gaps[name]
        assert kernel <= SSD_BWD_FACTOR * chunked, (name, kernel, chunked)
        assert _rel(sums[i], exact[i]) <= SSD_BWD_F32_TOL, (name, _rel(sums[i], exact[i]))


@pytest.mark.gpu
def test_ssd_scan_backward_log_decay_gradients_match_float64(cuda):
    """ddt and dA over SSD_BWD_CASES: the kernel's worst gap to float64
    autograd of ``ssd_chunked`` within SSD_BWD_FACTOR x float32
    ``ssd_chunked``'s worst (module note)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_tc_kernel

    worst = {"dt": [0.0, 0.0], "A": [0.0, 0.0]}
    for chunk, S, with_gh in SSD_BWD_CASES:
        inputs, gy, gh = _ssd_bwd_case(cuda, chunk, S, with_gh)
        gaps, _ = _ssd_bwd_gaps(ssd_scan_bwd_tc_kernel(*inputs, gy, gh, chunk), inputs, gy, gh,
                                chunk)
        for name, w in worst.items():
            w[0], w[1] = max(w[0], gaps[name][0]), max(w[1], gaps[name][1])
    for name, (kernel, chunked) in worst.items():
        assert kernel <= SSD_BWD_FACTOR * chunked, (name, kernel, chunked)


@pytest.mark.gpu
def test_ssd_scan_float32_backward_stays_autograd_of_ssd_chunked(cuda):
    """Outside the tensor-core domain (float32 here) the backward is
    autograd of ``ssd_chunked``: the backward kernel never launches."""

    inputs = _ssd_inputs(1, 300, 2, 64, 128, torch.float32, cuda, seed=3)
    a = [t.clone().requires_grad_(True) for t in inputs]
    before = dict(LAUNCHES)
    y, h = t_ops.ssd_scan(*a, chunk=128)
    (y.sum() + h.sum()).backward()
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, ssd_scan=before["ssd_scan"] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in a)


@pytest.mark.gpu
def test_k3_and_k5_refuse_inputs_that_need_a_gradient(cuda):
    """The raw launchers record no gradient and refuse inputs that need
    one; the entry points of `ops` differentiate through the backward
    kernels instead (a query offset, which training never uses, raises)."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel

    q = torch.randn(1, 64, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="records no gradient"):
        flash_attention_kernel(q, k, k)
    a = torch.rand(1, 8, 32, device=cuda)
    b = torch.randn(1, 8, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        rglru_scan_kernel(a, b)
    assert t_ops.flash_attention(q, k, k).requires_grad
    assert t_ops.rglru_scan(a, b)[0].requires_grad
    with pytest.raises(ValueError, match="q_offset"):
        t_ops.flash_attention(q, k, k, q_offset=8)
    with torch.no_grad():  # serving: no gradient, the forward kernels run
        assert t_ops.flash_attention(q, k, k).shape == q.shape
        assert t_ops.rglru_scan(a, b)[0].shape == b.shape


# ---- the backward kernels (K3, K5) ------------------------------------------

# K3's backward against its twin from the same inputs, output, log-sum-exp
# and output gradient, normwise: f32 at round-off (other summation orders;
# dQ by atomics in any order), bf16 at a few bf16 ulps of the rounded
# gradients (both compute in f32 from the same bf16 values).
FA_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _bwd_inputs(B, H, KV, S, hd, dtype, window, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(TORCH[dtype]).to(device)
    k, v = (torch.randn(B, S, KV, hd, generator=g).to(TORCH[dtype]).to(device) for _ in range(2))
    do = torch.randn(B, S, H, hd, generator=g).to(TORCH[dtype]).to(device)
    o, lse = t_ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, return_lse=True,
    )
    return q, k, v, o.transpose(1, 2).contiguous(), do, lse.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,S,hd,window",
    [
        (2, 4, 2, 256, 128, None),  # GQA
        (1, 8, 1, 300, 256, 100),  # MQA, a window, ragged tiles
        (2, 4, 4, 130, 64, None),
        (1, 16, 8, 1024, 128, None),  # the qwen3-0.6b heads
        (1, 16, 1, 600, 256, 256),  # the recurrentgemma-9b heads
        (2, 4, 2, 1000, 128, None),  # S not a multiple of a key or query tile
        (1, 4, 2, 300, 128, 48),  # a window narrower than one key tile
        (1, 16, 1, 512, 128, None),  # MQA at batch 1: a head split > 1
        (2, 8, 2, 512, 64, 200),  # hd 64: each warpgroup's columns half a box
    ],
)
def test_flash_attention_bwd_kernel_matches_plain_version(cuda, dtype, B, H, KV, S, hd, window):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel

    q, k, v, o, do, lse = _bwd_inputs(B, H, KV, S, hd, dtype, window, cuda, S + hd)
    before = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_kernel(q, k, v, o, do, lse, causal=True, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    want = t_ref.flash_attention_bwd_ref(
        *(t.transpose(1, 2) for t in (q, k, v, o, do)), lse, True, window
    )
    for name, g_, w in zip("qkv", got, want):
        w = w.transpose(1, 2)
        assert g_.dtype == w.dtype and g_.shape == w.shape, name
        assert torch.isfinite(g_).all(), name
        assert _normwise(g_, w) <= FA_BWD_TOL[dtype], name


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_bwd_kernel_dk_dv_are_the_same_bits_every_run(cuda, hd):
    """Only dQ is summed by atomics: dK and dV of two calls on the same
    inputs are equal bit for bit (bf16, the tensor-core body)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel

    q, k, v, o, do, lse = _bwd_inputs(2, 8, 2, 700, hd, "bfloat16", None, cuda, hd)
    first = flash_attention_bwd_kernel(q, k, v, o, do, lse, causal=True)
    second = flash_attention_bwd_kernel(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert _normwise(first[0], second[0]) <= FA_BWD_TOL["bfloat16"]


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["q", "k", "v", "dout"])
def test_flash_attention_bwd_tensor_core_body_refuses_a_misaligned_view(cuda, operand):
    """A contiguous bf16 view one element past a 16-byte boundary (TMA
    cannot map it) raises ValueError before any launch, and the context
    stays usable: the same values at an aligned address then meet the
    plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel

    args = dict(zip(("q", "k", "v", "out", "dout", "lse"),
                    _bwd_inputs(1, 4, 2, 200, 128, "bfloat16", None, cuda, 3)))
    view = _at_offset(args[operand], 1)
    assert view.is_contiguous() and view.data_ptr() % 16
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_bwd_kernel(**dict(args, **{operand: view}), causal=True)
    assert LAUNCHES == before
    got = flash_attention_bwd_kernel(**dict(args, **{operand: view.clone()}), causal=True)
    torch.cuda.synchronize()
    want = t_ref.flash_attention_bwd_ref(
        *(args[n].transpose(1, 2) for n in ("q", "k", "v", "out", "dout")), args["lse"], True, None
    )
    for name, g_, w in zip("qkv", got, want):
        assert _normwise(g_, w.transpose(1, 2)) <= FA_BWD_TOL["bfloat16"], name


@pytest.mark.gpu
def test_flash_attention_forward_lse_is_the_plain_one(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    for dtype, hd in (("float32", 128), ("bfloat16", 128), ("bfloat16", 256)):
        q, k, v, _, _, lse = _bwd_inputs(2, 4, 2, 333, hd, dtype, 100, cuda, hd)
        out, got = flash_attention_kernel(q, k, v, causal=True, window=100, return_lse=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == lse.shape
        assert (got - lse).abs().max().item() <= 1e-4, dtype


# K5's backward against its twin, normwise: the same reverse recurrence in
# f32, composed chunk by chunk (another order of the same products).
RG_BWD_TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(2, 512, 4096), (1, 1000, 300), (1, 2049, 300), (1, 4096, 4096)])
def test_rglru_scan_bwd_kernel_matches_plain_version(cuda, B, S, W, with_h0):
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_kernel

    g = torch.Generator(device="cpu").manual_seed(S + W)
    a = (torch.rand(B, S, W, generator=g) * 0.8 + 0.2).to(cuda)
    h = torch.randn(B, S, W, generator=g).to(cuda)
    dh = torch.randn(B, S, W, generator=g).to(cuda)
    dl = torch.randn(B, W, generator=g).to(cuda)
    h0 = torch.randn(B, W, generator=g).to(cuda) if with_h0 else None
    before = LAUNCHES["rglru_scan_bwd"]
    da, db, dh0 = rglru_scan_bwd_kernel(a, h, h0, dh, dl)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan_bwd"] == before + 1
    want = t_ref.rglru_scan_bwd_ref(a, h, h0, dh, dl)
    for name, got, w in zip(("da", "db", "dh0"), (da, db, dh0), want):
        assert torch.isfinite(got).all(), name
        assert _normwise(got, w) <= RG_BWD_TOL, name


@pytest.mark.gpu
def test_autograd_through_k3_and_k5_on_the_card(cuda):
    """ops.flash_attention and ops.rglru_scan on CUDA tensors that need a
    gradient: one forward and one backward launch each, gradients equal
    to autograd of the plain versions (f32 round-off)."""

    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(2, 200, 4, 64, generator=g).to(cuda).requires_grad_(True)
    kv = torch.randn(2, 2, 200, 2, 64, generator=g).to(cuda).requires_grad_(True)
    before = dict(LAUNCHES)
    out = t_ops.flash_attention(q, kv[0], kv[1], causal=True, window=50)
    do = torch.randn(out.shape, generator=g).to(cuda)
    got = torch.autograd.grad(out, (q, kv), do)
    assert LAUNCHES == dict(before, flash_attention=before["flash_attention"] + 1,
                            flash_attention_bwd=before["flash_attention_bwd"] + 1)
    ref_out = t_ref.flash_attention_ref(
        q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2), True, 50
    ).transpose(1, 2)
    want = torch.autograd.grad(ref_out, (q, kv), do)
    for got_, want_ in zip(got, want):
        assert _normwise(got_, want_) <= 1e-5

    a = (torch.rand(2, 100, 40, generator=g) * 0.8 + 0.2).to(cuda).requires_grad_(True)
    b = torch.randn(2, 100, 40, generator=g).to(cuda).requires_grad_(True)
    h0 = torch.randn(2, 40, generator=g).to(cuda).requires_grad_(True)
    before = dict(LAUNCHES)
    h, h_last = t_ops.rglru_scan(a, b, h0)
    dh = torch.randn(h.shape, generator=g).to(cuda)
    got = torch.autograd.grad((h * dh).sum() + h_last.sum(), (a, b, h0))
    assert LAUNCHES == dict(before, rglru_scan=before["rglru_scan"] + 1,
                            rglru_scan_bwd=before["rglru_scan_bwd"] + 1)
    hr, hlr = t_ref.rglru_scan_ref(a, b, h0)
    want = torch.autograd.grad((hr * dh).sum() + hlr.sum(), (a, b, h0))
    for got_, want_ in zip(got, want):
        assert _normwise(got_, want_) <= 1e-5


# The mixer's causal conv + SiLU (csrc/causal_conv.cu). The forward is held
# bit for bit to the plain expression F.silu(layers.causal_conv(...)) in every
# dtype. The gradients against float64 (the twin causal_conv_silu_bwd_ref on
# the same values in float64, which the CPU tests hold to float64 autograd of
# the expression): in bfloat16 and float32 within CONV_BWD_FACTOR x the gap of
# autograd of the expression on the same inputs (the path the kernel
# replaces: float32 arithmetic, the input dtype's rounding points), K4's
# backward rule. In bfloat16 that autograd rounds dpre to bfloat16, as the
# kernel does, and the kernel's gaps read equal to its on the card; against
# float32 autograd from float32 leaves, which rounds only its result, the
# kernel's dx read 1.86 x its gap at the cells' call and 2.08 x at W = 1,
# where dx is one tap times a rounded dpre. In float64 within TOL["float64"].
CONV_BWD_FACTOR = 2.0
# (B, S, C, W, dtype, in-projection width or None): with a width, x is the
# column slice [di, di + C) of a (B, S, width) in-projection output, read
# through its row stride as the mixer reads it (mamba2-1.3b and granite:
# width 8512 = 4096 + 4352 + 64; the smoke config: 552 = 256 + 288 + 8).
CONV_CASES = [
    (8, 2048, 4352, 4, "bfloat16", 8512),  # the mamba2 cells' call
    (2, 8192, 4352, 4, "bfloat16", 8512),  # the granite cell's call
    (2, 600, 4352, 4, "bfloat16", None),  # ragged S
    (3, 1, 288, 4, "bfloat16", None),  # S < W
    (3, 3, 288, 4, "bfloat16", 552),  # S < W, strided
    (2, 600, 288, 1, "bfloat16", None),
    (2, 600, 290, 3, "bfloat16", None),  # C off every vector width: one channel a thread
    (2, 600, 288, 2, "float32", 552),
    (2, 600, 288, 3, "float32", None),
    (3, 1, 288, 2, "float32", None),  # S < W
    (1, 5, 7, 3, "float32", None),  # C off every vector width
    (2, 600, 288, 4, "float64", 552),
    (2, 600, 288, 1, "float64", None),
    (3, 3, 288, 4, "float64", None),  # S < W
]
CONV_DI = {8512: 4096, 552: 256}  # where the slice starts: the width of z


def _conv_inputs(cuda, B, S, C, W, dtype, width):
    """(x, w, b, g) on the card: x a slice of a (B, S, width) matrix when
    ``width`` is given, conv_w-sized weights (std 0.2), bias and output
    gradient."""
    dt = TORCH[dtype]
    g = torch.Generator(device="cpu").manual_seed(B * S + C + W)
    if width is None:
        x = torch.randn(B, S, C, generator=g).to(dt).to(cuda)
    else:
        di = CONV_DI[width]
        x = torch.randn(B, S, width, generator=g).to(dt).to(cuda)[:, :, di:di + C]
        assert not x.is_contiguous() and x.stride(1) == width
    w = (0.2 * torch.randn(W, C, generator=g)).to(dt).to(cuda)
    b = (0.1 * torch.randn(C, generator=g)).to(dt).to(cuda)
    gy = torch.randn(B, S, C, generator=g).to(dt).to(cuda)
    return x, w, b, gy


def _conv_plain_grads(x, w, b, gy, dtype):
    from repro_torch.models.layers import causal_conv

    leaves = [t.to(dtype).detach().requires_grad_(True) for t in (x, w, b)]
    out = torch.nn.functional.silu(causal_conv(*leaves))
    return [gr.to(t.dtype) for gr, t in zip(torch.autograd.grad(out, leaves, gy.to(dtype)),
                                            (x, w, b))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,C,W,dtype,width", CONV_CASES)
def test_causal_conv_silu_kernel_is_the_plain_expression_bit_for_bit(cuda, B, S, C, W, dtype,
                                                                     width):
    """The forward kernel's output equals F.silu(layers.causal_conv(...))
    to the bit, contiguous in the input's dtype, one launch counted."""
    from repro_torch.kernels.causal_conv import causal_conv_silu_kernel
    from repro_torch.models.layers import causal_conv

    x, w, b, _ = _conv_inputs(cuda, B, S, C, W, dtype, width)
    before = dict(LAUNCHES)
    got = causal_conv_silu_kernel(x, w, b)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, causal_conv_silu=before["causal_conv_silu"] + 1)
    assert got.dtype == x.dtype and got.is_contiguous()
    assert torch.equal(got, torch.nn.functional.silu(causal_conv(x, w, b)))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,C,W,dtype,width", CONV_CASES)
def test_causal_conv_silu_backward_kernel_matches_float64(cuda, B, S, C, W, dtype, width):
    """dx, dw and db against float64 (module note), in the input's dtype,
    the same bits on a second run, one launch counted a call."""
    from repro_torch.kernels.causal_conv import causal_conv_silu_bwd_kernel

    x, w, b, gy = _conv_inputs(cuda, B, S, C, W, dtype, width)
    before = dict(LAUNCHES)
    got = causal_conv_silu_bwd_kernel(x, w, b, gy)
    again = causal_conv_silu_bwd_kernel(x, w, b, gy)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, causal_conv_silu_bwd=before["causal_conv_silu_bwd"] + 2)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert [t.dtype for t in got] == [x.dtype] * 3
    exact = t_ref.causal_conv_silu_bwd_ref(*(t.double() for t in (x, w, b, gy)))
    if dtype == "float64":
        for name, k, e in zip(("dx", "dw", "db"), got, exact):
            assert _rel(k, e) <= TOL["float64"]["rtol"], (name, _rel(k, e))
        return
    plain = _conv_plain_grads(x, w, b, gy, x.dtype)
    for name, k, p, e in zip(("dx", "dw", "db"), got, plain, exact):
        assert torch.isfinite(k).all(), name
        assert _rel(k, e) <= CONV_BWD_FACTOR * _rel(p, e), (name, _rel(k, e), _rel(p, e))


@pytest.mark.gpu
def test_causal_conv_silu_through_ops_on_the_card(cuda):
    """`ops.causal_conv_silu` on a strided CUDA slice that needs a gradient:
    one forward and one backward launch, the forward kernel's output and the
    backward kernel's gradients; widths beyond 4 and mixed dtypes raise."""
    from repro_torch.kernels.causal_conv import (
        causal_conv_silu_bwd_kernel,
        causal_conv_silu_kernel,
    )

    x, w, b, gy = _conv_inputs(cuda, 2, 300, 288, 4, "bfloat16", 552)
    leaves = [t.clone().requires_grad_(True) for t in (w, b)]
    xs = x.detach().requires_grad_(True)
    before = dict(LAUNCHES)
    out = t_ops.causal_conv_silu(xs, *leaves)
    got = torch.autograd.grad(out, [xs, *leaves], gy)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, causal_conv_silu=before["causal_conv_silu"] + 1,
                            causal_conv_silu_bwd=before["causal_conv_silu_bwd"] + 1)
    assert torch.equal(out, causal_conv_silu_kernel(x, w, b))
    assert all(torch.equal(u, v)
               for u, v in zip(got, causal_conv_silu_bwd_kernel(x, w, b, gy)))
    with pytest.raises(ValueError, match="W <= 4"):
        t_ops.causal_conv_silu(x, torch.zeros(5, 288, dtype=x.dtype, device=cuda), b)
    with pytest.raises(ValueError, match="bfloat16"):
        t_ops.causal_conv_silu(x, w.float(), b)
