"""The granite family (`repro_torch.models.granite`) against the plain
float32 reference `tests/granite_reference.py`, on the CPU at the smoke
size with seeded random weights: logits, the loss, every leaf's gradient,
one clipped Adam step, and prefill then decode against the full forward.
Also the config, the training launcher in both modes and the spans.

The family is the port's own, so these tests hold it to the published
equations (the reference) and not to the JAX package.

Tolerances (normwise: the largest absolute gap over the largest absolute
reference value, per tensor): the port and the reference compute the same
function in float32 in different orders (a chunked SSD and blocked
attention against a step-by-step recurrence and a full softmax), so they
agree to float32 round-off, a few 1e-7 of a value's size, grown by the
depth and the sums: the tests read at most 5.4e-7 (logits, prefill and
decode included, over weight seeds), 0 (loss), 3.9e-6 (gradients, the
worst leaf), and 1.3e-5 of the Adam step's norm. ``TOL`` leaves room of about 10 x above them. Computed in
bfloat16 the reference misses every one of them by 10 x or more
(`test_a_bfloat16_reference_fails_the_tolerances`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import granite_reference as ref
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, get_smoke_config
from repro_torch.distributed import PlainRuntime
from repro_torch.launch import train
from repro_torch.models import from_reference, get_model, to_reference
from repro_torch.models.config import GraniteConfig, ModelConfig
from repro_torch.models.registry import empty_model

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke model's operations are small: with several test processes
    at once, a thread a core in each makes every one wait on the others
    (as in portbench/conftest.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCH = "granite-4.0-h-micro"
B, S = 2, 64  # two chunks of the smoke model's 32
# Float32 round-off of two orders of the same sums (module docstring).
TOL = {"logits": 5e-6, "loss": 1e-6, "grad": 5e-5, "adam": 1e-4}


def _model(impl="kernel", remat="none", seed=3):
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_impl=impl, ssm_impl=impl,
                              remat=remat)
    return get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _batch(vocab, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, vocab, (B, s))) for k in ("tokens", "labels")}


def _gap(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _ref_params(model, dtype=torch.float32):
    return {n: p.detach().to(dtype).clone().requires_grad_() for n, p in
            model.named_parameters()}


def _ref_cfg(model) -> dict:
    return dataclasses.asdict(model.cfg)


def _ref_readings(model, batch, dtype=torch.float32):
    """The reference's (logits, loss, grads) from the model's weights."""
    p = _ref_params(model, dtype)
    cfg = _ref_cfg(model)
    logits = ref.logits(p, batch["tokens"], cfg)
    loss = ref.loss(p, batch["tokens"], batch["labels"], cfg)
    loss.backward()
    return logits, loss, {n: t.grad for n, t in p.items()}


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_logits_loss_and_gradients_match_the_reference(impl):
    model = _model(impl).requires_grad_(True)
    batch = _batch(model.cfg.vocab)
    logits = model._logits(model.forward(batch["tokens"]))
    loss, _ = model.loss(batch)
    loss.backward()
    r_logits, r_loss, r_grads = _ref_readings(model, batch)
    assert _gap(logits, r_logits) <= TOL["logits"]
    loss, r_loss = float(loss.detach()), float(r_loss.detach())
    assert abs(loss - r_loss) <= TOL["loss"] * r_loss
    for n, p in model.named_parameters():
        assert _gap(p.grad, r_grads[n]) <= TOL["grad"], n


def test_an_adam_step_matches_the_reference():
    """One step of the training runtime (clip at 1.0, Adam) against the
    reference's, each leaf's change normwise in the 2-norm. The first step
    moves a weight by lr g / (|g| + eps), about lr * sign(g): a weight
    whose gradient is within round-off of 0 may move by any fraction of
    lr, so the largest single gap says nothing, the norm of the gaps
    does."""
    model = _model()
    before = _ref_params(model)
    batch = _batch(model.cfg.vocab, seed=1)
    _, _, r_grads = _ref_readings(model, batch)
    lr = 1e-3
    rt = PlainRuntime(model, lr=lr)
    rt.train_step(rt.init_state(), batch)
    want = ref.clip_and_adam({n: t.detach() for n, t in before.items()}, r_grads, lr)
    for n, p in model.named_parameters():
        moved, start = want[n] - before[n].detach(), before[n].detach()
        gap = float((p.detach() - start - moved).norm() / moved.norm())
        assert gap <= TOL["adam"], n


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_then_decode_match_the_full_forward(impl):
    """A prompt of 40 (a ragged chunk), then 4 decode steps through the
    cache (SSM state, conv tail and KV side by side), against the
    reference's logits of the whole sequence at each position."""
    model = _model(impl)
    toks = _batch(model.cfg.vocab, seed=2, s=44)["tokens"]
    full = ref.logits(_ref_params(model), toks, _ref_cfg(model)).detach()
    logits, cache = model.prefill(toks[:, :40], extra_slots=4)
    assert _gap(logits[:, 0], full[:, 39]) <= TOL["logits"]
    assert cache["ssm"].shape[0] == 2 and cache["k"].shape[:3] == (2, B, 44)
    for t in range(40, 44):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        assert _gap(logits[:, 0], full[:, t]) <= TOL["logits"], t
    assert cache["len"] == 44


def test_a_bfloat16_reference_fails_the_tolerances():
    """The reference computed in bfloat16 from the same weights misses the
    logits', the loss's and the gradients' tolerances by 10 x or more."""
    model = _model()
    batch = _batch(model.cfg.vocab)
    logits, loss, grads = _ref_readings(model, batch)
    b_logits, b_loss, b_grads = _ref_readings(model, batch, torch.bfloat16)
    assert _gap(b_logits, logits) >= 10 * TOL["logits"]
    loss, b_loss = float(loss.detach()), float(b_loss.detach())
    assert abs(b_loss - loss) >= 10 * TOL["loss"] * loss
    assert max(_gap(b_grads[n], g) for n, g in grads.items()) >= 10 * TOL["grad"]


def test_spans_mark_each_mixer_and_mlp_on_the_forward_and_the_recompute():
    model = _model(remat="full").requires_grad_(True)
    batch = _batch(model.cfg.vocab, s=32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss, _ = model.loss(batch)
        loss.backward()
    names = [e.name for e in prof.events()]
    # two Mamba and two attention layers, an MLP each; each layer runs twice
    assert (names.count("granite.ssm_mixer"), names.count("granite.attn_mixer"),
            names.count("granite.mlp")) == (4, 4, 8)


def test_config_and_registry():
    full, smoke = get_config(ARCH), get_smoke_config(ARCH)
    assert ARCH in PORT_ARCHS and ARCH not in ARCHS
    assert full.layer_types.count("attention") == 4
    assert [i for i, t in enumerate(full.layer_types) if t == "attention"] == [5, 15, 25, 35]
    assert (full.attention_multiplier, full.remat, full.dtype) == (1 / 64, "full", "bfloat16")
    model = empty_model(smoke, "cpu")
    assert smoke.param_count() == sum(p.numel() for p in model.parameters())
    d = dataclasses.asdict(full)
    again = ModelConfig.from_dict(dict(d, layer_types=list(d["layer_types"])))
    assert isinstance(again, GraniteConfig) and again == full
    assert set(d) - set(f.name for f in dataclasses.fields(ModelConfig)) == {
        "layer_types", "embedding_multiplier", "residual_multiplier",
        "attention_multiplier", "logits_scaling", "norm_eps"}
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(smoke, layer_types=("mamba",)).validate()
    assert ModelConfig.from_dict(dict(d, layer_types=list(d["layer_types"]),
                                      position_embedding_type="nope")) == full
    with pytest.raises(ValueError, match="nope"):
        ModelConfig.from_dict(dict(d, position_embedding_type="rope"))


def test_checkpoint_layout_stacks_each_kind_apart_and_loads_back():
    model = _model()
    tree = to_reference(model)
    assert tree["mamba"]["w_in"].shape[0] == 2 and tree["attention"]["wq"].shape[0] == 2
    back = from_reference(model.cfg, tree, "cpu")
    for n, p in model.named_parameters():
        assert torch.equal(dict(back.named_parameters())[n], p), n


@pytest.mark.parametrize("mode", ["plain", "consensus"])
def test_train_cli_runs_and_learns(mode, capsys):
    """`launch/train.py --arch granite-4.0-h-micro` in both modes (remat
    "full" against "none": `tests/test_torch_remat.py`; the consensus
    step against the reference: `tests/test_torch_consensus_lm.py`)."""
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode,
                      "--steps", "3", "--batch", "2", "--seq", "32", "--lr", "3e-3"])
    assert out["model"].cfg.remat == "full" and all(np.isfinite(out["losses"]))
    if mode == "plain":
        assert out["losses"][-1] < out["losses"][0]
    else:  # csI-ADMM moves slowly from its start; the model serves z at the end
        for n, p in out["model"].named_parameters():
            assert torch.equal(p.detach(), out["state"]["z"][n]), n
    assert f"training {ARCH} (smoke) on cpu mode={mode}" in capsys.readouterr().out
