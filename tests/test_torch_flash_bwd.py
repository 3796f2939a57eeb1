"""K3's backward on the CPU: its launch plan, and the rounding of its
tensor-core body.

The plan (``repro_torch.kernels.flash_attention.bwd_plan``) is plain
Python: which main body runs (by dtype alone: bf16 the tensor-core body,
f32 the CUDA-core body), how many keys a block holds, and the head split
that fills the card. Its cases are the training shapes of qwen3-0.6b and
recurrentgemma-9b and the shapes of the card tests
(``tests/test_torch_kernels_gpu.py``), at every head dim and dtype.

The tensor-core body rounds P and dS to bf16 before the dV, dK and dQ
products and accumulates in f32 (what SDPA's and FA3's backward do).
``_tc_rounding_model`` is that arithmetic in plain torch. It is held,
normwise (max |model - exact| / max |exact|), against the exact gradient
on the same bf16-valued inputs, from ``flash_attention_bwd_ref`` in f64
and from ``jax.vjp`` of `repro`'s jnp attention in f64 (its module's
``jnp`` replaced by a view whose ``float32`` is ``float64``, as in
``tests/test_torch_backward.py``), at the card's bf16 bound for the
kernel, ``ATTN_BWD_TOL[bf16] = 2e-2``: the design's rounding fits the
bound before the card checks the kernel.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as r_ref
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import BWD_KEYS, HEAD_DIMS, bwd_plan, head_split

SMS = 132  # the H100's SMs
ATTN_BWD_TOL_BF16 = 2e-2  # chip_smoke.ATTN_BWD_TOL[torch.bfloat16]
SRC = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/flash_attention.cu"

# (B, KV, q_per_kv, S): the two training shapes, then the card tests'.
PLAN_SHAPES = [
    (4, 8, 2, 2048),  # qwen3-0.6b, [train-qwen3]
    (1, 1, 16, 4096),  # recurrentgemma-9b, [train-rg]
    (8, 8, 2, 2048),  # qwen3-0.6b, one agent of [consensus-qwen3]
    (2, 2, 2, 256),
    (1, 1, 8, 300),
    (2, 4, 1, 130),
    (1, 8, 2, 1024),
    (1, 1, 16, 600),
    (2, 2, 2, 1000),
    (1, 2, 2, 300),
    (1, 1, 16, 512),
    (2, 2, 4, 512),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("B,KV,qpk,S", PLAN_SHAPES)
def test_bwd_plan(B, KV, qpk, S, hd, dtype):
    plan = bwd_plan(dtype, B, KV, qpk, S, hd, SMS)
    want_body = "flash_attention_bwd_tc_kernel" if dtype == torch.bfloat16 else "flash_attention_bwd_kernel"
    assert plan.body == want_body
    assert plan.keys == BWD_KEYS[want_body][hd]
    n_key_tiles = -(-S // plan.keys)
    assert qpk % plan.split == 0 and plan.split & (plan.split - 1) == 0
    assert plan.blocks == n_key_tiles * plan.split * B * KV
    # Two blocks an SM wherever a split can give them; no split beyond that.
    assert plan.blocks >= 2 * SMS or plan.split == qpk or qpk % (2 * plan.split)
    if plan.split > 1:
        assert plan.blocks // 2 < 2 * SMS
    assert plan.split == head_split(B, KV, qpk, n_key_tiles, SMS)


def test_bwd_plan_keys_are_the_sources():
    """BWD_KEYS mirrors kBK of the source's two main bodies."""
    bwd = SRC.read_text().split("namespace bwd {", 1)[1]
    tcb = bwd.split("namespace tcb {", 1)[1]
    assert int(re.search(r"constexpr int kBK = (\d+);", tcb).group(1)) == 64
    assert all(k == 64 for k in BWD_KEYS["flash_attention_bwd_tc_kernel"].values())
    cc = re.search(r"static constexpr int kBK = HD <= 128 \? (\d+) : (\d+);", bwd)
    assert {hd: int(cc.group(1) if hd <= 128 else cc.group(2)) for hd in HEAD_DIMS} == \
        BWD_KEYS["flash_attention_bwd_kernel"]


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _tc_rounding_model(q, k, v, o, do, lse, causal, window):
    """The tensor-core body's arithmetic in plain torch, (B, heads, S, hd)
    layout: S, dP and D in f32 from the bf16 inputs; P and dS in f32, then
    rounded to bf16; dV = P^T dO, dK = dS^T Q / sqrt(hd), dQ = dS K /
    sqrt(hd) accumulated in f32; dK and dV summed over each kv head's
    query heads."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    f = torch.float32
    scale = 1.0 / math.sqrt(hd)
    q, k, v, o, do = (t.to(f) for t in (q, k, v, o, do))
    kx, vx = ref._expand_heads(k, H), ref._expand_heads(v, H)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kx)
    band = ref._band(S, S, causal, window, 0, q.device)
    p = torch.where(band[None, None], torch.exp2(s * (scale * math.log2(math.e))
                                                 - lse.to(f)[..., None] * math.log2(math.e)), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vx)
    ds = p * (dp - (do * o).sum(-1)[..., None])
    p, ds = _bf16_round(p), _bf16_round(ds)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale

    def per_kv(t):
        return t.reshape(B, KV, H // KV, S, hd).sum(2)

    return dq, per_kv(dk), per_kv(dv)


class _Jnp64:
    """``jax.numpy`` with its ``float32`` name bound to ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _normwise(got, want) -> float:
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.numpy() if isinstance(want, torch.Tensor) else want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, H, KV, S, hd, window): GQA; MQA with a window shorter than S; a
# ragged S (not a multiple of 64) with GQA 4:1 and a window; MQA across
# three 64-key tiles with a window narrower than one.
ROUNDING_CASES = [
    (2, 4, 2, 70, 16, None),
    (1, 4, 1, 90, 32, 20),
    (2, 8, 2, 37, 8, 16),
    (1, 2, 1, 130, 64, 48),
]


@pytest.mark.parametrize("B,H,KV,S,hd,window", ROUNDING_CASES)
def test_tc_rounding_model_meets_the_bf16_bound(monkeypatch, B, H, KV, S, hd, window):
    monkeypatch.setattr(r_ref, "jnp", _Jnp64())
    rng = np.random.default_rng(S * H + hd)
    # bf16-valued inputs, as the card's kernel reads them, held in f64.
    qn, don = (rng.standard_normal((B, H, S, hd)) for _ in range(2))
    kn, vn = (rng.standard_normal((B, KV, S, hd)) for _ in range(2))
    q, k, v, do = (_bf16_round(torch.from_numpy(a)) for a in (qn, kn, vn, don))
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, window=window, return_lse=True)
    exact = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True, window)
    # The forward's output is bf16 on the card; D reads it so.
    model = _tc_rounding_model(q, k, v, _bf16_round(o), do, lse, True, window)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: r_ref.flash_attention_ref(q_, k_, v_, causal=True, window=window),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)),
    )
    want_r = vjp(jnp.asarray(do.numpy()))
    for name, m, w, wr in zip("qkv", model, exact, want_r):
        assert m.dtype == torch.float32 and w.dtype == torch.float64, name
        assert np.asarray(wr).dtype == np.float64, name
        # The two exact gradients agree to f64 round-off, which dS = P (dP - D)
        # amplifies by its cancellation. Measured 4.7e-16 to 6.9e-16 normwise
        # over these cases, the same bits on one thread, on eight and under
        # torch.use_deterministic_algorithms; a reading of 1.6e-10 seen once
        # before was never reproduced, so no cause is shown for it and the
        # bound stays where it was.
        assert _normwise(w, np.asarray(wr)) <= 1e-8, name
        gap = _normwise(m, w)
        assert gap <= ATTN_BWD_TOL_BF16, (name, gap)
        assert _normwise(m, np.asarray(wr)) <= ATTN_BWD_TOL_BF16, name
        assert gap > 1e-5, (name, gap)  # the bf16 rounding does show
