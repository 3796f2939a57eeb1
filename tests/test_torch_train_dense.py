"""Training of the dense (qwen3), hybrid (recurrentgemma), MoE (phi3.5-moe,
mixtral) and VLM (qwen2-vl, with its vision stub) families in the port
against the reference's, on the CPU.

- ``Transformer.loss`` and ``RecurrentGemma.loss`` and every parameter's
  gradient against ``jax.value_and_grad`` of the reference's ``loss_fn``
  at float64, with and without ``loss_weights`` and ``remat="full"``, on
  the kernel route (on the CPU: the plain twins under autograd) and the
  plain path: loss relative 1e-12, gradients normwise 1e-9 (float64
  round-off through the smoke depth, the embedding and the loss). The
  reference casts to float32 in its layers; it runs here with the module
  attribute ``jnp`` of `repro.models.{transformer,rglru,layers,losses}`
  replaced by a view of ``jax.numpy`` whose ``float32`` is ``float64``
  (no file of `repro` is changed), as tests/test_torch_train.py does for
  mamba2; the MoE and VLM smoke models the same way, their ``moe_aux``
  (the routers' load-balance loss, part of the total) relative 1e-12, an
  MoE case at capacity factor 1.0 so that tokens are dropped, and the
  vision stub's ``extra_embeds`` in the batch;
- the in-place clipping and Adam step that `PlainRuntime` takes, bit
  for bit the functional ones (which tests/test_torch_train.py holds to
  the reference);
- the train CLI's plain mode on both smoke configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as r_layers
import repro.models.losses as r_losses
import repro.models.rglru as r_rglru
import repro.models.transformer as r_transformer
from repro.configs import get_smoke_config as r_smoke_config
from repro.models import get_model as r_get_model
from repro_torch.launch import train
from repro_torch.models import ModelConfig, from_reference
from repro_torch.models.params import flat_to_reference
from repro_torch.optim import (
    adam_init,
    adam_update,
    adam_update_,
    clip_by_global_norm,
    clip_by_global_norm_,
)


class _Jnp64:
    """``jax.numpy`` with its ``float32`` name bound to ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def reference_in_f64(monkeypatch):
    for mod in (r_transformer, r_rglru, r_layers, r_losses):
        monkeypatch.setattr(mod, "jnp", _Jnp64())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(t, np.float64)


def _normwise(got, want) -> float:
    got, want = _np64(got), _np64(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(vocab, B, S, seed, weights, stub_width=None):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
        "labels": rng.integers(0, vocab, (B, S), dtype=np.int32),
    }
    batch["labels"][0, :5] = -100  # ignored positions
    if weights:
        batch["loss_weights"] = rng.random(B)
    if stub_width is not None:
        batch["extra_embeds"] = rng.standard_normal((B, 16, stub_width))
    return batch


def _grads_as_reference(model):
    """The model's .grad tensors in the reference's stacked layout."""
    return _flat(flat_to_reference(model, {n: p.grad for n, p in model.named_parameters()}))


# (weights, remat, the port's impl): each family with and without loss
# weights and remat, on both routes.
CASES = [
    (False, "none", "kernel"),
    (True, "full", "kernel"),
    (True, "none", "plain"),
    (False, "full", "plain"),
]


def _loss_and_gradients(arch, weights, remat, impl, **overrides):
    """(port's loss, metrics, {name: grad}; reference's loss, metrics,
    {name: grad}) on one batch at float64."""
    # S = 80 > the hybrid and mixtral smoke windows (64): the window masks keys.
    cfg_r = dataclasses.replace(
        r_smoke_config(arch), dtype="float64", remat=remat, **overrides
    )
    model_r = r_get_model(cfg_r)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), model_r.init(jax.random.key(3)))
    cfg_t = dataclasses.replace(
        ModelConfig.from_dict(dataclasses.asdict(cfg_r)), attn_impl=impl, ssm_impl=impl
    )
    model_t = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    model_t.to(torch.float64).requires_grad_(True)  # the RG-LRU's f32 gate params too
    stub = cfg_t.d_model if cfg_t.modality == "vision_stub" else None
    batch = _batch(cfg_t.vocab, 2, 80, seed=5, weights=weights, stub_width=stub)
    (loss_r, aux_r), grads_r = jax.value_and_grad(model_r.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    loss_t, metrics = model_t.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss_t.backward()
    return loss_t, metrics, _grads_as_reference(model_t), loss_r, aux_r, _flat(grads_r)


@pytest.mark.parametrize("weights,remat,impl", CASES)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b"])
def test_loss_and_gradients_match_jax_grad_f64(reference_in_f64, arch, weights, remat, impl):
    loss_t, metrics, got, loss_r, aux_r, want = _loss_and_gradients(arch, weights, remat, impl)
    assert loss_t.dtype == torch.float64
    assert abs(loss_t.item() - float(loss_r)) <= 1e-12 * abs(float(loss_r))
    assert abs(metrics["nll"].item() - float(aux_r["nll"])) <= 1e-12 * abs(float(loss_r))
    assert float(metrics["moe_aux"]) == float(aux_r["moe_aux"]) == 0.0
    assert set(got) == set(want)
    for name, g in want.items():
        assert _normwise(got[name], g) <= 1e-9, name


# (arch, weights, remat, the port's impl, capacity factor or None for the
# config's): the MoE archs on both routes, one case with drops; the VLM
# backbone with its vision stub.
MOE_VLM_CASES = [
    ("phi3.5-moe-42b-a6.6b", False, "none", "kernel", None),
    ("phi3.5-moe-42b-a6.6b", True, "full", "plain", 1.0),
    ("mixtral-8x22b", True, "full", "kernel", None),
    ("mixtral-8x22b", False, "none", "plain", None),
    ("qwen2-vl-72b", False, "full", "kernel", None),
    ("qwen2-vl-72b", True, "none", "plain", None),
]


@pytest.mark.parametrize("arch,weights,remat,impl,capacity", MOE_VLM_CASES)
def test_moe_and_vlm_loss_and_gradients_match_jax_grad_f64(
    reference_in_f64, arch, weights, remat, impl, capacity
):
    """Loss (total, nll, moe_aux) and every gradient, the routers' and
    ``vis_proj``'s included, against ``jax.value_and_grad``."""
    overrides = {} if capacity is None else {"capacity_factor": capacity}
    loss_t, metrics, got, loss_r, aux_r, want = _loss_and_gradients(
        arch, weights, remat, impl, **overrides
    )
    assert loss_t.dtype == torch.float64
    assert abs(loss_t.item() - float(loss_r)) <= 1e-12 * abs(float(loss_r))
    assert abs(metrics["nll"].item() - float(aux_r["nll"])) <= 1e-12 * abs(float(loss_r))
    aux = float(aux_r["moe_aux"])
    assert abs(metrics["moe_aux"].item() - aux) <= 1e-12 * max(abs(aux), 1e-30)
    assert (aux > 0) == arch.startswith(("phi", "mixtral"))
    assert set(got) == set(want)
    routed = [n for n in want if n.endswith(("router", "vis_proj"))]
    assert routed and all(np.abs(_np64(want[n])).max() > 0 for n in routed)
    for name, g in want.items():
        assert _normwise(got[name], g) <= 1e-9, name


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b"])
def test_train_cli_plain_mode_trains_dense_and_hybrid(arch, capsys):
    out = train.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
        "--seq", "32", "--log-every", "1",
    ])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert f"training {arch} (smoke) on cpu mode=plain remat=full" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_optimizer_is_the_functional_one_bit_for_bit(dtype):
    """PlainRuntime's in-place clip and Adam step give the functional
    ones' values bit for bit, and the functional ones leave their inputs
    as they were."""
    rng = np.random.default_rng(11)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 2, 4)}
    params = {k: torch.from_numpy(rng.standard_normal(s)).to(dtype) for k, s in shapes.items()}
    state, state_ = adam_init(params), adam_init(params)
    params_ = {k: p.clone() for k, p in params.items()}
    for step in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(s) * 3).to(dtype) for k, s in shapes.items()}
        grads_ = {k: g.clone() for k, g in grads.items()}
        clipped, gn = clip_by_global_norm(grads, 1.0)
        assert torch.equal(gn, clip_by_global_norm_(grads_, 1.0))
        m_before = {k: m.clone() for k, m in state["m"].items()}
        params, new_state = adam_update(params, clipped, state, 1e-2, weight_decay=0.01 * step)
        for k in shapes:
            assert torch.equal(state["m"][k], m_before[k])  # the input state is untouched
        state = new_state
        out = adam_update_(params_, grads_, state_, 1e-2, weight_decay=0.01 * step)
        assert out is state_ and state_["t"] == state["t"] == step + 1
        for k in shapes:
            assert torch.equal(grads_[k], clipped[k])
            assert torch.equal(params_[k], params[k]), k
            assert torch.equal(state_["m"][k], state["m"][k]) and torch.equal(state_["v"][k], state["v"][k])
