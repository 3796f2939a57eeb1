"""The port's training slice (mamba2) against the reference's, on the CPU.

Inputs come from numpy seeds; weights from `repro`'s ``init`` through
`repro_torch.models.from_reference`. Held here:

- the SSD scan's gradient (`repro_torch.kernels.ops.ssd_scan`, an
  autograd Function whose backward is the port's plain ``ssd_chunked``)
  against ``jax.grad`` of the reference's ``ssd_chunked``, and a
  ``torch.autograd.gradcheck``;
- the mamba2 smoke model's loss on each path pairing, its parameter
  gradients against ``jax.grad`` of the reference's ``loss_fn``, and the
  reference's prefill/decode consistency check on the port;
- the optimizer (clipping, SGD, Adam), ``lm_loss``, the token stream, the
  checkpoint format both ways, three ``PlainRuntime.train_step``s against
  the reference's, and the training CLI.

Float64: the reference's SSD code casts to float32 explicitly (and its
``lax.scan`` carries raise on float64 ``dt``), and its norms and loss widen
to float32. The f64 checks run the reference's own code with the module
attribute ``jnp`` of `repro.models.{mamba2,layers,losses}` replaced by a
view of ``jax.numpy`` whose ``float32`` is ``float64`` (no file of
`repro` is changed); the port computes in ``promote(dtype, float32)``,
which is float64 there. Tolerances are stated beside each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as r_layers
import repro.models.losses as r_losses
import repro.models.mamba2 as r_mamba2
from repro.checkpoint import restore_step as r_restore_step
from repro.checkpoint import save_step as r_save_step
from repro.configs import get_smoke_config as r_smoke_config
from repro.data import agent_token_streams as r_streams
from repro.data import make_lm_batch as r_make_batch
from repro.distributed.plain import PlainRuntime as RPlainRuntime
from repro.models import get_model as r_get_model
from repro.models.losses import lm_loss as r_lm_loss
from repro.optim import adam_init as r_adam_init
from repro.optim import adam_update as r_adam_update
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import sgd_update as r_sgd_update
from repro.optim import schedules as r_schedules
from repro_torch.checkpoint import restore_step, save_step
from repro_torch.data import agent_token_streams, make_lm_batch
from repro_torch.distributed import PlainRuntime
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import ModelConfig, from_reference, to_reference
from repro_torch.models.losses import lm_loss
from repro_torch.models.mamba2 import ssd_chunked
from repro_torch.optim import adam_init, adam_update, clip_by_global_norm, schedules, sgd_update

ARCH = "mamba2-1.3b"
REF_IMPL = {"kernel": "pallas", "plain": "jnp"}


class _Jnp64:
    """``jax.numpy`` with its ``float32`` name bound to ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def reference_in_f64(monkeypatch):
    for mod in (r_mamba2, r_layers, r_losses):
        monkeypatch.setattr(mod, "jnp", _Jnp64())


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


def _normwise(got, want) -> float:
    got, want = _np64(got), _np64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _ssd_inputs(B, S, H, P, N, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    A = -np.exp(rng.standard_normal(H))
    Bm = rng.standard_normal((B, S, N)) / np.sqrt(N)
    Cm = rng.standard_normal((B, S, N)) / np.sqrt(N)
    gy = rng.standard_normal((B, S, H, P))
    gh = rng.standard_normal((B, H, P, N))
    return [a.astype(dtype) for a in (x, dt, A, Bm, Cm)], [a.astype(dtype) for a in (gy, gh)]


def _port_grads(inputs, cots, chunk):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y, h = ops.ssd_scan(*leaves, chunk=chunk)
    gy, gh = (torch.from_numpy(c) for c in cots)
    torch.autograd.backward([y, h], [gy, gh])
    return [t.grad for t in leaves]


def _reference_grads(inputs, cots, chunk):
    gy, gh = (jnp.asarray(c) for c in cots)

    def f(*args):
        y, h = r_mamba2.ssd_chunked(*args, chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in inputs))


# ---- K4's gradient -------------------------------------------------------

SSD_SHAPES = [(1, 200, 2, 16, 32, 64), (2, 128, 4, 8, 16, 32), (1, 37, 3, 4, 8, 16)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_gradient_matches_jax_grad_of_ssd_chunked_f64(
    reference_in_f64, B, S, H, P, N, chunk
):
    """Gradients for x, dt, A, Bm, Cm through both outputs, f64, normwise
    1e-10 (two f64 evaluations of the same chunked algebra)."""
    inputs, cots = _ssd_inputs(B, S, H, P, N, seed=S + H)
    got = _port_grads(inputs, cots, chunk)
    want = _reference_grads(inputs, cots, chunk)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm"), got, want):
        assert _normwise(g, w) <= 1e-10, name


def test_ssd_scan_gradient_matches_unchanged_reference_f32():
    """The reference as it stands (float32 algebra) against the port in
    float32: normwise 1e-4 (float32 round-off in two summation orders,
    through up to 200 steps of decay)."""
    inputs, cots = _ssd_inputs(1, 200, 2, 16, 32, seed=3, dtype=np.float32)
    got = _port_grads(inputs, cots, 64)
    want = _reference_grads(inputs, cots, 64)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm"), got, want):
        assert g.dtype == torch.float32
        assert _normwise(g, w) <= 1e-4, name


def test_ssd_scan_gradcheck_f64():
    """Finite differences against the Function's backward (both outputs,
    a ragged S), at gradcheck's default f64 tolerances."""
    inputs, _ = _ssd_inputs(1, 10, 2, 3, 4, seed=11)
    leaves = tuple(torch.from_numpy(a).requires_grad_(True) for a in inputs)
    assert torch.autograd.gradcheck(lambda *a: ops.ssd_scan(*a, chunk=4), leaves)


def test_ssd_scan_gradient_only_for_what_needs_it():
    inputs, _ = _ssd_inputs(1, 20, 2, 4, 8, seed=2)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in inputs)
    x.requires_grad_(True)
    y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    y.sum().backward()
    assert x.grad is not None and dt.grad is None and Bm.grad is None
    y2, _ = ssd_chunked(x.detach().requires_grad_(True), dt, A, Bm, Cm, 8)
    assert _normwise(y, y2) <= 1e-12


# ---- the mamba2 model ------------------------------------------------------


def _pair(impl, **overrides):
    cfg_r = dataclasses.replace(
        r_smoke_config(ARCH), ssm_impl=REF_IMPL[impl], **overrides
    )
    model_r = r_get_model(cfg_r)
    params = model_r.init(jax.random.key(0))
    cfg_t = ModelConfig.from_dict(dataclasses.asdict(cfg_r))
    return model_r, params, cfg_t


def _batch(vocab, B, S, seed, weights=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels[0, :5] = -100  # ignored positions
    batch = {"tokens": tokens, "labels": labels}
    if weights:
        batch["loss_weights"] = rng.random(B).astype(np.float32)
    return batch


@pytest.mark.parametrize(
    "impl,ref_impl", [("kernel", "pallas"), ("kernel", "jnp"), ("plain", "jnp")]
)
@pytest.mark.parametrize("weights", [False, True])
def test_mamba2_loss_matches_reference(impl, ref_impl, weights):
    """The smoke model (float32) on S = 70 (ragged against chunk 32):
    relative 1e-5 (float32 round-off)."""
    cfg_r = dataclasses.replace(r_smoke_config(ARCH), ssm_impl=ref_impl)
    model_r = r_get_model(cfg_r)
    params = model_r.init(jax.random.key(0))
    cfg_t = dataclasses.replace(ModelConfig.from_dict(dataclasses.asdict(cfg_r)), ssm_impl=impl)
    model_t = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    batch = _batch(cfg_t.vocab, 2, 70, seed=4, weights=weights)
    loss_r, _ = model_r.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, metrics = model_t.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss_t) - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    assert float(metrics["nll"]) == float(loss_t)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba2_gradients_match_jax_grad_f64(reference_in_f64, impl):
    """Every parameter's gradient of the smoke model at f64 against
    jax.grad of the reference's loss_fn (its jnp path: the Pallas kernel
    has no gradient), normwise 1e-9 (f64 round-off through two layers,
    the embedding and the loss)."""
    cfg_r = dataclasses.replace(r_smoke_config(ARCH), dtype="float64")
    model_r = r_get_model(cfg_r)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), model_r.init(jax.random.key(0)))
    cfg_t = dataclasses.replace(ModelConfig.from_dict(dataclasses.asdict(cfg_r)), ssm_impl=impl)
    model_t = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    model_t.to(torch.float64).requires_grad_(True)
    batch = _batch(cfg_t.vocab, 2, 45, seed=8, weights=True)
    (loss_r, _), grads_r = jax.value_and_grad(model_r.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    loss_t, _ = model_t.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_r)) <= 1e-12 * abs(float(loss_r))
    got = to_reference_grads(model_t)
    assert set(got) == set(_flat(grads_r))
    for name, g in got.items():
        assert _normwise(g, _flat(grads_r)[name]) <= 1e-9, name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def to_reference_grads(model):
    """The model's .grad tensors in the reference's stacked layout."""
    grads = {n: p.grad for n, p in model.named_parameters(recurse=False)}
    layers = {}
    for name, _ in model.layers[0].named_parameters(recurse=False):
        layers[name] = torch.stack([getattr(b, name).grad for b in model.layers])
    return _flat(dict(grads, layers=layers))


def test_mamba2_prefill_decode_consistency():
    """The reference's check on the port: prefill on S tokens then decode
    token S equals prefill on S + 1 tokens (rtol 2e-2, atol 2e-3, as
    there; measured far closer in float32)."""
    _, params, cfg_t = _pair("kernel")
    model = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg_t.vocab, (2, 33)))
    logits_a, cache = model.prefill(tokens[:, :32], extra_slots=1)
    assert logits_a.shape == (2, 1, cfg_t.vocab)
    logits_b, cache2 = model.decode_step(cache, tokens[:, 32:])
    logits_full, _ = model.prefill(tokens)
    np.testing.assert_allclose(logits_b.numpy(), logits_full.numpy(), rtol=2e-2, atol=2e-3)
    assert cache2["len"] == 33 and torch.isfinite(logits_b).all()


def test_remat_full_gives_the_same_loss_and_gradients():
    """Checkpointing recomputes the layers in the backward pass: on the CPU
    the recomputation repeats the same operations, so the results are
    bitwise those without it, under "full" and under "dots"
    (tests/test_torch_remat.py holds every family)."""
    _, params, cfg_t = _pair("kernel")
    tree = jax.tree.map(np.asarray, params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg_t.vocab, 2, 40, seed=1).items()}
    out = []
    for remat in ("none", "full", "dots"):
        model = from_reference(dataclasses.replace(cfg_t, remat=remat), tree, "cpu")
        model.requires_grad_(True)
        loss, _ = model.loss(batch)
        loss.backward()
        out.append((loss, [p.grad for p in model.parameters()]))
    for loss, grads in out[1:]:
        assert torch.equal(out[0][0], loss)
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], grads))


# ---- optimizer, loss, data, checkpoints ------------------------------------


def _param_dicts(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": ((4, 5), "float32"), "b": ((7,), "bfloat16"), "c": ((3, 2, 2), "float32")}
    p_np = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in shapes.items()}
    g_np = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in shapes.items()}
    dt = {k: d for k, (_, d) in shapes.items()}
    return p_np, g_np, dt


def _both(arrays, dtypes):
    j = {k: jnp.asarray(v).astype(getattr(jnp, dtypes[k])) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtypes[k])) for k, v in arrays.items()}
    return j, t


def _close_tree(got, want, rtol):
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        np.testing.assert_allclose(_np64(got[k]), _np64(want[k]), rtol=rtol, atol=rtol, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])  # clipping and not
def test_clip_and_sgd_match_reference(max_norm):
    """float32 1e-6; bf16 leaves at 2^-8 (one bf16 rounding)."""
    p_np, g_np, dt = _param_dicts(0)
    (pj, pt), (gj, gt) = _both(p_np, dt), _both(g_np, dt)
    gj2, gnj = r_clip(gj, max_norm)
    gt2, gnt = clip_by_global_norm(gt, max_norm)
    assert abs(float(gnt) - float(gnj)) <= 1e-6 * float(gnj)
    _close_tree(gt2, gj2, 2**-8)
    _close_tree(sgd_update(pt, gt2, 0.1), r_sgd_update(pj, gj2, 0.1), 2**-8)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_reference(weight_decay):
    """Three steps: float32 moments at 1e-6, parameters at 2^-8 (bf16
    leaves round once per step), the step count as an int."""
    p_np, _, dt = _param_dicts(1)
    pj, pt = _both(p_np, dt)
    sj, st = r_adam_init(pj), adam_init(pt)
    for step in range(3):
        _, g_np, _ = _param_dicts(10 + step)
        gj, gt = _both(g_np, dt)
        pj, sj = r_adam_update(pj, gj, sj, 1e-2, weight_decay=weight_decay)
        pt, st = adam_update(pt, gt, st, 1e-2, weight_decay=weight_decay)
        _close_tree(pt, pj, 2**-8)
        for k in ("m", "v"):
            assert all(v.dtype == torch.float32 for v in st[k].values())
            _close_tree(st[k], sj[k], 1e-6)
        assert st["t"] == int(sj["t"]) == step + 1


def test_schedules_match_reference():
    """tau^k, gamma^k and the constant schedule: float32, bitwise."""
    pairs = [
        (schedules.rsqrt_growth(0.3), r_schedules.rsqrt_growth(0.3)),
        (schedules.rsqrt_decay(0.7), r_schedules.rsqrt_decay(0.7)),
        (schedules.constant(0.25), r_schedules.constant(0.25)),
        *zip(schedules.admm_schedule(2.0, 0.1), r_schedules.admm_schedule(2.0, 0.1)),
    ]
    for ours, theirs in pairs:
        for k in (1, 2, 7, 100):
            got, want = ours(k), theirs(k)
            assert got.dtype == torch.float32 and got.shape == ()
            assert float(got) == float(want), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", [False, True])
def test_lm_loss_matches_reference(dtype, weights):
    """Ignored labels (< 0, a whole row of them too) and row weights;
    relative 1e-6 (logits widened to float32 on both sides)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 6)).astype(np.int32)
    labels[0, 2] = -100
    labels[1, :] = -1
    w = rng.random(3).astype(np.float32) if weights else None
    lj = r_lm_loss(jnp.asarray(logits).astype(getattr(jnp, dtype)), jnp.asarray(labels),
                   None if w is None else jnp.asarray(w))
    lt = lm_loss(torch.from_numpy(logits).to(getattr(torch, dtype)), torch.from_numpy(labels),
                 None if w is None else torch.from_numpy(w))
    assert lt.dtype == torch.float32
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))


def test_token_stream_is_bitwise_the_reference():
    ours, theirs = agent_token_streams(3, 1000, seed=5), r_streams(3, 1000, seed=5)
    for a, b in zip(ours, theirs):
        for _ in range(3):
            x, y = make_lm_batch(a, 4, 33), r_make_batch(b, 4, 33)
            assert set(x) == set(y) == {"tokens", "labels"}
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bf16 as uint16), for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_load_bitwise(tmp_path, dtype):
    """A checkpoint written by the port is read by repro.checkpoint, and one
    written by the reference by the port: every leaf bitwise."""
    model_r, params, cfg_t = _pair("kernel", dtype=dtype)
    params = jax.tree.map(lambda a: a + 0.125 * jnp.ones_like(a), params)  # not the init
    model_t = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    tree = to_reference(model_t)
    save_step(str(tmp_path / "port"), 3, tree)
    got_r, step = r_restore_step(str(tmp_path / "port"), params)
    assert step == 3
    flat_r, flat_t, flat_p = _flat(got_r), _flat(tree), _flat(params)
    assert set(flat_r) == set(flat_t) == set(flat_p)
    for k in flat_p:
        assert np.array_equal(_bits(flat_r[k]), _bits(flat_p[k])), k
        assert np.array_equal(_bits(flat_t[k]), _bits(flat_p[k])), k
    r_save_step(str(tmp_path / "ref"), 5, params)
    got_t, step = restore_step(str(tmp_path / "ref"), tree)
    assert step == 5
    back = from_reference(cfg_t, got_t, "cpu")
    for (n, p), (_, q) in zip(back.named_parameters(), model_t.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    with pytest.raises(ValueError, match="mismatch"):
        restore_step(str(tmp_path / "ref"), dict(tree, extra=torch.zeros(1)))


# ---- the training step and the CLI ------------------------------------------


def test_three_train_steps_match_reference():
    """PlainRuntime.train_step (loss, backward, clip at 1.0, Adam) three
    times from the same weights and batches as the reference's, float32:
    losses and grad norms relative 1e-5; parameters normwise 1e-4, a tenth
    of the learning rate (Adam divides each gradient element by its own
    size, so elements whose float32 gradient is round-off move by up to
    lr per step on either side; measured 2.8e-5)."""
    model_r, params, cfg_t = _pair("plain")  # the Pallas path has no gradient
    cfg_t = dataclasses.replace(cfg_t, ssm_impl="kernel")
    rt_r = RPlainRuntime(model_r, jax.make_mesh((1, 1, 1), ("agent", "data", "model")), lr=1e-3)
    state_r = {"params": params, "opt": r_adam_init(params)}
    model_t = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    rt_t = PlainRuntime(model_t, lr=1e-3)
    state_t = rt_t.init_state()
    stream = agent_token_streams(1, cfg_t.vocab, seed=3)[0]
    for _ in range(3):
        batch = make_lm_batch(stream, 2, 48)
        state_r, m_r = rt_r.train_step(state_r, {k: jnp.asarray(v) for k, v in batch.items()})
        state_t, m_t = rt_t.train_step(state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "nll", "grad_norm"):
            assert abs(float(m_t[key]) - float(m_r[key])) <= 1e-5 * abs(float(m_r[key])), key
    flat_r, flat_t = _flat(state_r["params"]), _flat(to_reference(model_t))
    for k in flat_r:
        assert _normwise(flat_t[k], flat_r[k]) <= 1e-4, k
    assert state_t["opt"]["t"] == 3


def test_train_cli_on_cpu(tmp_path, capsys):
    out = train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
    ])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["model"].cfg.remat == "full"
    text = capsys.readouterr().out
    assert "training mamba2-1.3b (smoke) on cpu mode=plain remat=full" in text
    assert "loss:" in text
    tree, step = restore_step(str(tmp_path))
    assert step == 3
    back = from_reference(out["model"].cfg, tree, "cpu")
    for p, q in zip(back.parameters(), out["model"].parameters()):
        assert torch.equal(p, q.detach())


def test_train_cli_refuses_what_is_not_ported():
    """Every arch is ported; without a card the default device raises
    rather than falling back to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(["--arch", "whisper-medium", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("mode", ["plain", "consensus"])
def test_train_cli_trains_whisper(mode, monkeypatch, capsys):
    """Both modes of the CLI on the whisper smoke config: every training
    batch (every agent's slice of it in consensus mode) carries the
    reference's stand-in frames, (rows, encoder_positions, D) of 0.01,
    one per token row; the reference's launcher leaves them out of its
    consensus batches, and its Whisper loss raises there."""
    from repro_torch.models.whisper import Whisper

    seen = []
    loss = Whisper.loss

    def recording_loss(self, batch):
        seen.append((batch["tokens"].shape[0], batch["extra_embeds"]))
        return loss(self, batch)

    monkeypatch.setattr(Whisper, "loss", recording_loss)
    out = train.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu", "--steps", "2",
                      "--batch", "16", "--seq", "16", "--log-every", "1", "--mode", mode])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert (f"training whisper-medium (smoke) on cpu mode={mode} remat=full"
            in capsys.readouterr().out)
    cfg = out["model"].cfg
    # plain: one loss a step; consensus (A 2, incremental): one per agent
    assert len(seen) == (2 if mode == "plain" else 4)
    for rows, ee in seen:
        assert rows == (16 if mode == "plain" else 8)
        assert torch.equal(ee, torch.full((rows, cfg.encoder_positions, cfg.d_model), 0.01))
    if mode == "consensus":
        assert out["residuals"][-1] > 0


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-vl-72b"])
def test_train_cli_trains_moe_and_vlm(arch, monkeypatch, capsys):
    """The plain mode of the CLI on the MoE and VLM smoke configs: the
    vision stub's stand-in embeddings ((batch, 16, D) of 0.01, the
    reference's) reach every training batch, an MoE model's loss carries
    its router aux loss."""
    from repro_torch.models.transformer import Transformer

    seen = []
    loss = Transformer.loss

    def recording_loss(self, batch):
        total, metrics = loss(self, batch)
        seen.append((batch.get("extra_embeds"), metrics["moe_aux"].item()))
        return total, metrics

    monkeypatch.setattr(Transformer, "loss", recording_loss)
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "32", "--log-every", "1"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert f"training {arch} (smoke) on cpu mode=plain remat=full" in capsys.readouterr().out
    cfg = out["model"].cfg
    assert len(seen) == 2
    for ee, aux in seen:
        if arch == "qwen2-vl-72b":
            assert torch.equal(ee, torch.full((2, 16, cfg.d_model), 0.01))
            assert aux == 0.0
        else:
            assert ee is None and aux > 0
