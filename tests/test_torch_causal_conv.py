"""The Mamba-2 mixer's causal conv + SiLU on the CPU: the plain float64 twin
of the CUDA backward (``ref.causal_conv_silu_bwd_ref``) against autograd of
the plain expression, and the CPU path of ``ops.causal_conv_silu``, which is
that expression. The kernels themselves run only on a card
(tests/test_torch_kernels_gpu.py)."""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.causal_conv import causal_conv_silu_kernel
from repro_torch.models import mamba2
from repro_torch.models.layers import causal_conv


def _inputs(B, S, C, W, dtype, seed=0):
    g = torch.Generator().manual_seed(seed + 97 * S + W)
    x = torch.randn(B, S, C, generator=g, dtype=torch.float64).to(dtype)
    w = (0.5 * torch.randn(W, C, generator=g, dtype=torch.float64)).to(dtype)
    b = (0.3 * torch.randn(C, generator=g, dtype=torch.float64)).to(dtype)
    gy = torch.randn(B, S, C, generator=g, dtype=torch.float64).to(dtype)
    return x, w, b, gy


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 3, 40])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_bwd_twin_is_float64_autograd_of_the_expression(W, S, dtype):
    """The twin's dx, dw, db equal float64 autograd of the conv + SiLU with
    the input dtype's rounding points (pre rounded before the SiLU; the
    round trip's backward rounds dpre there too) at 1e-12, for every width,
    S below and above W: the transposed taps, the dpre rounding point, dw
    and db of the kernel's closed form."""
    x, w, b, gy = _inputs(2, S, 6, W, dtype)
    leaves = [t.to(torch.float64).requires_grad_(True) for t in (x, w, b)]
    xl, wl, bl = leaves
    pad = F.pad(xl, (0, 0, W - 1, 0))
    out = pad[:, 0:S] * wl[0]
    for j in range(1, W):
        out = out + pad[:, j:j + S] * wl[j]
    y = F.silu((out + bl).to(dtype).to(torch.float64))
    want = torch.autograd.grad(y, leaves, gy.to(torch.float64))
    got = ref.causal_conv_silu_bwd_ref(x, w, b, gy)
    for name, g_, w_ in zip(("dx", "dw", "db"), got, want):
        assert g_.dtype == torch.float64
        assert _rel(g_, w_) <= 1e-12, (name, _rel(g_, w_))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("W", [1, 4])
def test_ops_on_the_cpu_is_the_plain_expression(W, dtype):
    """``ops.causal_conv_silu`` on CPU tensors (a column slice, as the
    mixer passes) is F.silu(layers.causal_conv(...)) bit for bit, output
    and gradients."""
    x, w, b, gy = _inputs(2, 9, 20, W, dtype, seed=1)
    wide = torch.cat([x, x], -1).requires_grad_(True)
    w, b, gy = w[:, 3:17], b[3:17], gy[:, :, 3:17]
    got_leaves = [wide[:, :, 3:17], w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    want_leaves = [t.detach().clone().requires_grad_(True) for t in got_leaves]
    got = ops.causal_conv_silu(*got_leaves)
    want = F.silu(causal_conv(*want_leaves))
    assert torch.equal(got, want)
    got_g = torch.autograd.grad(got, [wide, *got_leaves[1:]], gy)
    want_g = torch.autograd.grad(want, want_leaves, gy)
    assert torch.equal(got_g[0][:, :, 3:17], want_g[0])
    assert all(torch.equal(u, v) for u, v in zip(got_g[1:], want_g[1:]))


@pytest.mark.parametrize("impl,calls", [("kernel", 1), ("plain", 0)])
def test_mixer_takes_the_conv_entry_point_on_the_kernel_path_only(monkeypatch, impl, calls):
    """`mamba2._mixer_in` calls ``ops.causal_conv_silu`` once for
    ``ssm_impl="kernel"`` and never for ``"plain"``, with the same xBC."""
    import dataclasses

    seen = []
    entry = ops.causal_conv_silu

    def counted(*args):
        seen.append(args[0].shape)
        return entry(*args)

    monkeypatch.setattr(ops, "causal_conv_silu", counted)
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), ssm_impl=impl)
    lp = mamba2.Mamba2Block(cfg, "cpu").init_(torch.Generator().manual_seed(0))
    h = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(1))
    out = mamba2._mixer_in(cfg, lp, h)
    assert len(seen) == calls
    plain = mamba2._mixer_in(dataclasses.replace(cfg, ssm_impl="plain"), lp, h)
    assert all(torch.equal(u, v) for u, v in zip(out, plain))


def test_kernel_launcher_refuses_cpu_tensors_and_gradients():
    """The raw launcher takes CUDA tensors only and records no gradient (the
    checks come before any build)."""
    x, w, b, _ = _inputs(1, 4, 8, 4, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        causal_conv_silu_kernel(x, w, b)
    with pytest.raises(RuntimeError, match="records no gradient"):
        causal_conv_silu_kernel(x, w.requires_grad_(True), b)
