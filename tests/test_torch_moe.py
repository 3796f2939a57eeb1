"""The port's ``moe_apply`` against the reference's, on the CPU in float32.

Both run on the same numpy inputs (seeded). The reference's routing is
read from its own call: ``jax.lax.top_k`` (expert indices) and
``jnp.take_along_axis`` (slot positions) are wrapped for the length of
one eager call, so nothing of `repro` changes. The port's routing comes
from the functions its ``moe_apply`` runs (``moe_route``, ``moe_slots``,
``moe_capacity``).

- Routing (expert index, slot position, keep) equals the reference's bit
  for bit in every case.
- Outputs and the aux loss are held normwise at 1e-5 * max(max |ref|, 1),
  as tests/test_torch_models.py holds the models (measured: at most
  2.7e-7 for the outputs and for aux).
- Gradients of a scalar of (out, aux) with respect to x, the router and
  the three expert weights, against ``jax.grad``: normwise at 1e-5 of
  max |ref| (measured: at most 3.5e-7, and 2.5e-6 for one router
  gradient).

Cases: the smoke configs' capacity factor (8.0, no drops); factor 1.0
(drops); T = 2 tokens as in a batch-2 decode step (C = 1); two groups;
a zero router, where every probability is exactly 1/E, every token ties
and the reference sends all of them to experts 0 and 1 until capacity
runs out: tie order and drop order in one case.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as r_layers
from repro_torch.models.layers import moe_apply, moe_capacity, moe_route, moe_slots

RTOL = 1e-5
GRAD_RTOL = 1e-5
D, F = 32, 24
WEIGHTS = ("router", "w_gate", "w_up", "w_down")

# (name, T, E, k, capacity_factor, groups, zero router)
CASES = [
    ("smoke_capacity", 24, 4, 2, 8.0, 1, False),
    ("drops", 24, 4, 2, 1.0, 1, False),
    ("decode_T2", 2, 4, 2, 1.25, 1, False),
    ("groups2", 24, 4, 2, 1.0, 2, False),
    ("top1_of_8", 32, 8, 1, 1.25, 1, False),
    ("zero_router", 16, 4, 2, 1.0, 1, True),
]


def _inputs(T, E, seed, zero_router):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    p = {
        "router": (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
        "w_up": (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
        "w_down": (rng.standard_normal((E, F, D)) * 0.2).astype(np.float32),
    }
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    r = rng.standard_normal((T, D)).astype(np.float32)  # the scalar's weights
    return x, p, r


class _RecordingJnp:
    """``jax.numpy`` whose ``take_along_axis`` records its result (the
    reference's slot positions)."""

    def __init__(self, seen):
        self.seen = seen

    def take_along_axis(self, *args, **kw):
        out = jnp.take_along_axis(*args, **kw)
        self.seen["pos"] = np.asarray(out)[..., 0]
        return out

    def __getattr__(self, name):
        return getattr(jnp, name)


def _reference(monkeypatch, x, p, E, k, cf, G):
    seen = {}
    top_k = jax.lax.top_k

    def recording_top_k(a, kk):
        vals, idx = top_k(a, kk)
        seen["idx"] = np.asarray(idx)
        return vals, idx

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", recording_top_k)
        m.setattr(r_layers, "jnp", _RecordingJnp(seen))
        out, aux = r_layers.moe_apply(
            jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()}, E, k, cf, groups=G
        )
    return np.asarray(out), float(aux), seen


def _port(x, p, E, k, cf, G, grad=False):
    xt = torch.from_numpy(x).requires_grad_(grad)
    pt = SimpleNamespace(**{n: torch.from_numpy(v).requires_grad_(grad) for n, v in p.items()})
    out, aux = moe_apply(xt, pt, E, k, cf, groups=G)
    return xt, pt, out, aux


def _close(got, want, tol, what, floor=1.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    gap = np.abs(got - want).max()
    scale = max(np.abs(want).max(), floor)
    assert gap <= tol * scale, f"{what}: gap {gap:.3e} > {tol:.0e} x {scale:.3e}"


@pytest.mark.parametrize("name,T,E,k,cf,G,zero", CASES, ids=[c[0] for c in CASES])
def test_routing_is_the_reference_bit_for_bit_and_outputs_agree(
    monkeypatch, name, T, E, k, cf, G, zero
):
    x, p, _ = _inputs(T, E, seed=T + E + G, zero_router=zero)
    out_r, aux_r, seen = _reference(monkeypatch, x, p, E, k, cf, G)

    Tg = T // G
    C = moe_capacity(Tg, cf, k, E)
    assert C == min(int(max(1, cf * Tg * k / E)), Tg)
    xt = torch.from_numpy(x)
    _, _, idx = moe_route(xt.reshape(G, Tg, D), torch.from_numpy(p["router"]), k)
    flat_e, pos, keep = moe_slots(idx, C, E)
    assert np.array_equal(idx.numpy(), seen["idx"]), "expert indices"
    assert np.array_equal(pos.numpy(), seen["pos"]), "slot positions"
    assert np.array_equal(keep.numpy(), seen["pos"] < C), "keep"
    assert np.array_equal(flat_e.numpy(), seen["idx"].reshape(G, Tg * k))

    _, _, out_t, aux_t = _port(x, p, E, k, cf, G)
    assert out_t.dtype == torch.float32 and aux_t.dtype == torch.float32
    _close(out_t.numpy(), out_r, RTOL, "out")
    _close(aux_t.item(), aux_r, RTOL, "aux")

    drops = int((~keep).sum())
    if name == "smoke_capacity":
        assert drops == 0
    elif name in ("drops", "decode_T2", "groups2"):
        assert drops > 0, name
    if name == "decode_T2":
        assert C == 1
    if zero:
        # Every token ties: experts 0 and 1 in that order, slot t for token
        # t, so tokens from C on are dropped on both and keep no output.
        assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()
        assert torch.equal(pos, torch.arange(T).repeat_interleave(k)[None])
        assert torch.equal(keep, pos < C)
        assert (out_t[C:] == 0).all() and (out_t[:C] != 0).any()


@pytest.mark.parametrize("name,T,E,k,cf,G,zero", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_jax_grad(name, T, E, k, cf, G, zero):
    """d/d(x, router, w_gate, w_up, w_down) of sum(out * r) + 3 aux."""
    x, p, r = _inputs(T, E, seed=T + E + G, zero_router=zero)

    def scalar_r(xx, pp):
        out, aux = r_layers.moe_apply(xx, pp, E, k, cf, groups=G)
        return jnp.sum(out * r) + 3.0 * aux

    gx_r, gp_r = jax.grad(scalar_r, argnums=(0, 1))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()}
    )
    xt, pt, out, aux = _port(x, p, E, k, cf, G, grad=True)
    ((out * torch.from_numpy(r)).sum() + 3.0 * aux).backward()
    _close(xt.grad.numpy(), gx_r, GRAD_RTOL, "d/dx", floor=1e-30)
    for n in WEIGHTS:
        _close(getattr(pt, n).grad.numpy(), gp_r[n], GRAD_RTOL, f"d/d{n}", floor=1e-30)
    if not zero:
        assert np.abs(np.asarray(gp_r["router"])).max() > 0  # the router is trained


def test_shard_axis_changes_nothing_and_ragged_groups_raise():
    x, p, _ = _inputs(24, 4, seed=1, zero_router=False)
    _, _, out, aux = _port(x, p, 4, 2, 1.0, 2)
    xt = torch.from_numpy(x)
    pt = SimpleNamespace(**{n: torch.from_numpy(v) for n, v in p.items()})
    out2, aux2 = moe_apply(xt, pt, 4, 2, 1.0, groups=2, shard_axis="data")
    assert torch.equal(out, out2) and torch.equal(aux, aux2)
    with pytest.raises(ValueError, match="groups"):
        moe_apply(xt, pt, 4, 2, 1.0, groups=5)
