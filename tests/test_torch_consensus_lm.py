"""The port's csI-ADMM training runtime against the reference's on the
LM smoke models, on the CPU (the runtime's own checks are in
tests/test_torch_consensus.py).

- two ``train_step``s of every ported arch's smoke model (float32) in
  both modes (the MoE models' router aux loss in the objective, the
  vision-stub model with the reference's stand-in embeddings in its
  batch, Whisper with the stand-in frames that the launcher's
  ``consensus_batches`` adds, as tests/test_consensus_all_archs.py hands
  them to the reference's runtime), from one state carried across
  (`repro_torch.models.params.consensus_state_from_reference`), on the
  same coded batches and alive masks (`repro_torch.launch.train.
  consensus_batches`, held bit for bit to the reference's launcher in
  tests/test_torch_consensus.py): loss, nll and residual relative 1e-4;
  x and z per leaf normwise 1e-4, y with the round-off bound stated in
  ``_check_state`` (both compute the updates in float32; the gradients
  differ by float32 round-off, about 1e-6);
- three steps of the launcher's ``run_consensus`` against the
  reference's (losses and residuals relative 1e-4, z normwise 1e-4, the
  checkpoint bit for bit the final z);
- the port's own granite family, which the reference lacks: the
  launcher's consensus mode on its smoke model, and the first step's loss
  and z against `tests/granite_reference.py`'s loss and gradient.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke_config
from repro.distributed import ConsensusConfig as RConfig
from repro.distributed import ConsensusRuntime as RRuntime
from repro.launch import train as r_train
from repro.models import get_model as r_get_model
import granite_reference
from repro_torch.checkpoint import restore_step
from repro_torch.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.models import ModelConfig, from_reference, get_model
from repro_torch.models.params import (
    consensus_state_from_reference,
    consensus_state_to_reference,
    flat_to_reference,
)


def _mesh():
    return jax.make_mesh((1, 1, 1), ("agent", "data", "model"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).cpu().numpy()
    return np.asarray(t, np.float64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _normwise(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _args(**kw):
    """The launcher's arguments (its consensus defaults), small."""
    base = dict(agents=2, ecns=4, stragglers=1, scheme="cyclic", rho=1.0, c_tau=20.0,
                c_gamma=0.1, consensus_mode="incremental", seed=0, steps=2, batch=8,
                seq=16, log_every=10, ckpt_dir=None, ckpt_every=100)
    base.update(kw)
    return SimpleNamespace(**base)


# ---- train_step against the reference, on the LM smoke models ---------------

ARCHS = ["qwen3-0.6b", "recurrentgemma-9b", "mamba2-1.3b", "phi3.5-moe-42b-a6.6b",
         "mixtral-8x22b", "qwen2-vl-72b", "llama3-405b", "stablelm-1.6b", "internlm2-20b",
         "whisper-medium"]


def _check_state(model, state_t, state_r, tol, steps, rho_gamma):
    """x, y and z of the port's state against the reference's, per leaf,
    normwise ``tol``. y is the running sum of rho gamma (z - x+), a
    difference of nearly equal float32 values: the rounding of x+ (to
    within an ulp or two of |x| in either implementation's order of
    operations) enters it as rho gamma 2^-23 |x| a step, which is more
    than ``tol`` of |y| for a leaf whose gradient is small against its
    weights. So y's bound adds 4 ulps of |x| per step (rho gamma 2^-22
    max |x|) to ``tol`` max |y|."""
    got = consensus_state_to_reference(model, state_t)
    for key in ("x", "y", "z"):
        flat_g, flat_w = _flat(got[key]), _flat(state_r[key])
        assert set(flat_g) == set(flat_w)
        for name, w in flat_w.items():
            err = np.abs(_np(flat_g[name]) - _np(w)).max()
            bound = tol * max(np.abs(_np(w)).max(), 1e-30)
            if key == "y":
                x_max = np.abs(_np(_flat(state_r["x"])[name])).max()
                bound += steps * rho_gamma * 2.0**-22 * x_max
            assert err <= bound, f"{key}/{name}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("mode", ["incremental", "parallel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, mode):
    args = _args(consensus_mode=mode)
    cfg_r = r_smoke_config(arch)
    model_r = r_get_model(cfg_r)
    ccfg = dict(n_agents=2, K=4, S=1, scheme="cyclic", rho=1.0, c_tau=20.0, c_gamma=0.1,
                mode=mode)
    rt_r = RRuntime(model_r, RConfig(**ccfg), _mesh())
    state_r = rt_r.init_state(jax.random.key(0))
    model_t = from_reference(
        ModelConfig.from_dict(dataclasses.asdict(cfg_r)),
        jax.tree.map(np.asarray, state_r["z"]), "cpu",
    )
    rt_t = ConsensusRuntime(model_t, ConsensusConfig(**ccfg))
    state_t = consensus_state_from_reference(model_t, jax.tree.map(np.asarray, state_r))
    step_r = jax.jit(rt_r.train_step)
    cfg_t = model_t.cfg
    for batch, alive in train.consensus_batches(args, rt_t.cfg.code(), cfg_r.vocab, cfg_t):
        if cfg_r.modality == "audio_stub":
            rows = batch["tokens"].shape[0]
            assert np.array_equal(batch["extra_embeds"], np.full(
                (rows, cfg_r.encoder_positions, cfg_r.d_model), 0.01, np.float32))
        if cfg_r.modality == "vision_stub":
            rows = batch["tokens"].shape[0]
            batch["extra_embeds"] = np.full((rows, 16, cfg_r.d_model), 0.01, np.float32)
        state_r, m_r = step_r(state_r, {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(alive))
        state_t, m_t = rt_t.train_step(
            state_t, {k: torch.from_numpy(v) for k, v in batch.items()}, alive
        )
        for key in ("loss", "nll", "consensus_residual", "tau", "gamma"):
            r = float(m_r[key])
            assert abs(float(m_t[key]) - r) <= 1e-4 * abs(r), key
        assert state_t["k"] == int(state_r["k"])
    _check_state(model_t, state_t, jax.tree.map(np.asarray, state_r), 1e-4, args.steps, 0.1)




def test_run_consensus_matches_reference(tmp_path, capsys):
    """Three steps of the launcher's consensus mode (qwen3 smoke, f32), the
    port from the reference's initial weights."""
    args = _args(steps=3, ckpt_dir=str(tmp_path), ckpt_every=3, log_every=1)
    cfg_r = r_smoke_config("qwen3-0.6b")
    model_r = r_get_model(cfg_r)
    out_r = r_train.run_consensus(model_r, _args(steps=3, log_every=1))
    params = model_r.init(jax.random.key(args.seed))  # the reference's start
    model_t = from_reference(ModelConfig.from_dict(dataclasses.asdict(cfg_r)),
                             jax.tree.map(np.asarray, params), "cpu")
    out_t = train.run_consensus(model_t, args)
    for key in ("losses", "residuals"):
        np.testing.assert_allclose(out_t[key], out_r[key], rtol=1e-4, atol=0)
    z_r = _flat(jax.tree.map(np.asarray, out_r["state"]["z"]))
    z_t = _flat(flat_to_reference(model_t, out_t["state"]["z"]))
    for name, w in z_r.items():
        assert _normwise(z_t[name], w) <= 1e-4, name
    # the model serves z at the end
    for n, p in model_t.named_parameters():
        assert torch.equal(p.detach(), out_t["state"]["z"][n])
    tree, step = restore_step(str(tmp_path))
    assert step == 3
    for name, w in _flat(tree).items():
        assert np.array_equal(_np(w), _np(z_t[name])), name
    assert "residual" in capsys.readouterr().out


def test_granite_consensus_step_follows_the_plain_reference():
    """One incremental step of granite's smoke model (float32) on the
    launcher's first coded batch. From x = z = the weights and y = 0,
    eqs. 5a, 5b and 4c move z by -(1 + gamma) g / (A (rho + tau)), g the
    committing agent 0's decoded gradient: that gradient and the step's
    loss (the agents' mean) are held to the plain reference's on the same
    rows and row weights. Tolerances: the loss to float32 round-off
    (1e-6); z's move normwise 1e-4 (the gradients' float32 round-off,
    as in ``_check_state``) plus the float32 roundings of eqs. 5a, 5b and
    4c, each within half an ulp of |z| (once 5a's sums are divided back by
    rho + tau), read back as a move: a few of them, 2^-21 max |z| times
    the scale, since the move is some 100 x smaller than the weights."""
    cfg = get_smoke_config("granite-4.0-h-micro")
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ccfg = ConsensusConfig(n_agents=2, K=4, S=1, scheme="cyclic", rho=1.0, c_tau=20.0,
                           c_gamma=0.1, mode="incremental")
    rt = ConsensusRuntime(model, ccfg)
    args = _args(steps=1)
    batch, alive = next(train.consensus_batches(args, ccfg.code(), cfg.vocab, cfg))
    state, m = rt.train_step(rt.init_state(), {k: torch.from_numpy(v) for k, v in
                                               batch.items()}, alive)
    rows = batch["tokens"].shape[0] // 2
    w = torch.from_numpy(rt.row_weights(alive, rows))
    tok, lab = (torch.from_numpy(batch[k]) for k in ("tokens", "labels"))
    p = {n: t.clone().requires_grad_() for n, t in start.items()}
    losses = [granite_reference.loss(p, tok[a * rows:(a + 1) * rows],
                                     lab[a * rows:(a + 1) * rows],
                                     dataclasses.asdict(cfg), row_weights=w[a])
              for a in range(2)]
    want = float(sum(losses).detach()) / 2
    assert abs(float(m["loss"]) - want) <= 1e-6 * want
    losses[0].backward()
    scale = 2 * (1.0 + 20.0) / (1 + float(m["gamma"]))
    for n, t in start.items():
        g = p[n].grad
        err = float(((t - state["z"][n]) * scale - g).abs().max())
        bound = 1e-4 * float(g.abs().max()) + scale * 2.0**-21 * float(t.abs().max())
        assert err <= bound, (n, err, bound)
