"""``remat`` (activation checkpointing of the layers) in the port, on the
CPU, for every arch's smoke config.

"dots" keeps the outputs of the matrix products without batch dimensions
(``aten.mm``/``aten.addmm``: ``x @ W`` on a (B, S, D) activation) and
recomputes everything else in the backward pass, the port's counterpart of
the reference's ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``.
"full" recomputes each layer from its input. Held here:

- the loss and every parameter's gradient under "dots" and under "full"
  equal those under "none" bit for bit (on the CPU the recomputation
  repeats the same operations);
- counted by a dispatch mode, no forward ``aten.mm`` runs again in the
  backward under "dots", while under "full" every product inside the
  layers does: the backward's count exceeds that of "none" by the
  forward's products less those outside the checkpointed layers (the
  tied or untied head, and the vision stub's projector). The count under
  "full" is taken with the recomputation's early stop off (by default it
  ends a layer's recomputation after its last saved value, and so skips
  a layer's final product, whose output no gradient reads).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.configs import ARCHS, PORT_ARCHS, get_smoke_config
from repro_torch.launch.serve import stub_embeds
from repro_torch.models import get_model

PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke models' operations are small: with several test processes
    at once, a thread a core in each makes every one wait on the others
    (as in portbench/conftest.py); one thread changes no result compared
    here, both sides of each comparison run in it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _batch(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
    }
    ee = stub_embeds(cfg, B, "cpu")
    if ee is not None:
        batch["extra_embeds"] = ee + torch.from_numpy(
            rng.standard_normal(ee.shape).astype(np.float32))
    return batch


def _model(arch, remat):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    return model.requires_grad_(True)


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_dots_and_full_give_the_loss_and_gradients_of_none_bit_for_bit(arch):
    out = {}
    for remat in ("none", "dots", "full"):
        model = _model(arch, remat)
        loss, metrics = model.loss(_batch(model.cfg))
        loss.backward()
        out[remat] = (loss, metrics["moe_aux"],
                      {n: p.grad for n, p in model.named_parameters()})
    loss, aux, grads = out["none"]
    assert all(g is not None for g in grads.values())
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], loss) and torch.equal(out[remat][1], aux), remat
        for name, g in grads.items():
            assert torch.equal(out[remat][2][name], g), (remat, name)


def _counts(arch, remat):
    """(products in the forward, products in the backward)."""
    model = _model(arch, remat)
    batch = _batch(model.cfg)
    with set_checkpoint_early_stop(False):
        with _CountProducts() as fwd:
            loss, _ = model.loss(batch)
        with _CountProducts() as bwd:
            loss.backward()
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_dots_saves_the_products_that_full_recomputes(arch):
    fwd, bwd_none = _counts(arch, "none")
    fwd_dots, bwd_dots = _counts(arch, "dots")
    fwd_full, bwd_full = _counts(arch, "full")
    assert fwd == fwd_dots == fwd_full
    assert bwd_dots == bwd_none
    outside = 2 if get_smoke_config(arch).modality == "vision_stub" else 1
    assert bwd_full - bwd_none == fwd - outside > 0
