"""The port's Whisper (the audio family) against the reference's, on the
CPU.

`repro` builds the whisper smoke model and initialises it with
``init(jax.random.key(0))``; `repro_torch.models.from_reference` carries
those weights into the port. Held here:

- ``encode``, ``prefill`` and 4 teacher-forced decode steps on the same
  numpy tokens and frames, at S = 12 (full-matrix attention) and S = 2048
  (the decoder's causal self-attention goes blocked, > 1024 positions):
  the encoder output, prefill logits, the whole cache (k, v, xk, xv,
  len) and each step's logits, normwise within 1e-5 x max(|ref|, 1), the
  float32 tolerance of tests/test_torch_models.py;
- the loss and every parameter's gradient against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` at float64 under
  ``remat`` "none", "full" and "dots", with and without
  ``loss_weights``: loss relative 1e-12, gradients normwise 1e-9. The
  reference casts to float32 in its layers; it runs here with the module
  attribute ``jnp`` of `repro.models.{whisper,layers,losses}` replaced by
  a view of ``jax.numpy`` whose ``float32`` is ``float64`` (no file of
  `repro` is changed), as tests/test_torch_train_dense.py does;
- decode past the 32,768 rows of the position table reads the last row,
  as JAX clamps the index;
- the weights both ways (``from_reference``/``to_reference``, missing
  and extra arrays refused) and through the npz checkpoint, read by the
  reference's ``restore_step``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as r_layers
import repro.models.losses as r_losses
import repro.models.whisper as r_whisper
from repro.checkpoint import restore_step as r_restore_step
from repro.configs import get_smoke_config as r_smoke_config
from repro.models import get_model as r_get_model
from repro_torch.checkpoint import save_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import ModelConfig, from_reference, get_model, to_reference
from repro_torch.models.params import flat_to_reference
from repro_torch.models.whisper import DEC_POSITIONS, Whisper

ARCH = "whisper-medium"
RTOL = 1e-5
DECODE_STEPS = 4


class _Jnp64:
    """``jax.numpy`` with its ``float32`` name bound to ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def reference_in_f64(monkeypatch):
    for mod in (r_whisper, r_layers, r_losses):
        monkeypatch.setattr(mod, "jnp", _Jnp64())


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(t, np.float64)


def _close(got, want, what):
    got, want = _np64(got), _np64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    gap = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1.0)
    assert gap <= RTOL * scale, f"{what}: gap {gap:.3e} > {RTOL:.0e} x {scale:.3e}"


def _normwise(got, want) -> float:
    got, want = _np64(got), _np64(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _pair(**overrides):
    cfg_r = dataclasses.replace(r_smoke_config(ARCH), **overrides)
    model_r = r_get_model(cfg_r)
    params = model_r.init(jax.random.key(0))
    if cfg_r.dtype == "float64":
        params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    model_t = from_reference(
        ModelConfig.from_dict(dataclasses.asdict(cfg_r)), jax.tree.map(np.asarray, params), "cpu"
    )
    return model_r, params, model_t


def _frames(rng, B, cfg, dtype=np.float32):
    return rng.standard_normal((B, cfg.encoder_positions, cfg.d_model)).astype(dtype)


def _check_cache(cache_r, cache_t, what):
    assert set(cache_r) == set(cache_t) == {"k", "v", "xk", "xv", "len"}
    assert int(cache_r["len"]) == cache_t["len"]
    for key in ("k", "v", "xk", "xv"):
        _close(cache_t[key], cache_r[key], f"{what} cache[{key}]")


@pytest.mark.parametrize("B,S", [(2, 12), (1, 2048)])
def test_encode_prefill_and_decode_match_reference(B, S):
    model_r, params, model_t = _pair()
    cfg = model_t.cfg
    assert isinstance(model_t, Whisper)
    rng = np.random.default_rng(S + B)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    frames = _frames(rng, B, cfg)
    with torch.no_grad():
        enc_t = model_t.encode(torch.from_numpy(frames))
    _close(enc_t, r_whisper.encode(model_r.cfg, params, jnp.asarray(frames)), "encoder output")
    logits_r, cache_r = model_r.prefill(
        params, jnp.asarray(tokens), jnp.asarray(frames), extra_slots=DECODE_STEPS
    )
    logits_t, cache_t = model_t.prefill(
        torch.from_numpy(tokens), torch.from_numpy(frames), extra_slots=DECODE_STEPS
    )
    assert tuple(cache_t["k"].shape) == (cfg.n_layers, B, S + DECODE_STEPS, cfg.n_kv_heads,
                                         cfg.d_head)
    _close(logits_t, logits_r, "prefill logits")
    _check_cache(cache_r, cache_t, "prefill")
    decode_r = jax.jit(model_r.decode)
    for step in range(DECODE_STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
        logits_r, cache_r = decode_r(params, cache_r, jnp.asarray(tok))
        logits_t, cache_t = model_t.decode_step(cache_t, torch.from_numpy(tok))
        _close(logits_t, logits_r, f"decode step {step} logits")
    _check_cache(cache_r, cache_t, "after decode")


def test_frames_of_another_shape_are_refused():
    model = get_model(get_smoke_config(ARCH), device="cpu")
    cfg = model.cfg
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for frames in (None, torch.zeros((1, cfg.encoder_positions - 1, cfg.d_model))):
        with pytest.raises(ValueError, match="frames"):
            model.prefill(tokens, frames)


def test_decode_past_the_position_table_reads_its_last_row():
    """A cache whose ``len`` lies past the 32,768 rows of ``dec_pos``: JAX
    clamps the gather to the last row, the port clamps explicitly; the
    ring slot is len % C in both. The step equals the step at len =
    32,767 from the same cache (same slot, every slot valid)."""
    model_r, params, model_t = _pair()
    cfg = model_t.cfg
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, 12), dtype=np.int32)
    frames = _frames(rng, 2, cfg)
    _, cache_r = model_r.prefill(params, jnp.asarray(tokens), jnp.asarray(frames), extra_slots=4)
    _, cache_t = model_t.prefill(torch.from_numpy(tokens), torch.from_numpy(frames),
                                 extra_slots=4)
    C = cache_t["k"].shape[2]
    n = DEC_POSITIONS - 1 + 64 * C
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32))
    at_last, _ = model_t.decode_step(
        {k: v.clone() if isinstance(v, torch.Tensor) else DEC_POSITIONS - 1
         for k, v in cache_t.items()}, tok)
    logits_r, cache_r = model_r.decode(params, dict(cache_r, len=jnp.asarray(n, jnp.int32)),
                                       jnp.asarray(tok.numpy()))
    logits_t, cache_t = model_t.decode_step(dict(cache_t, len=n), tok)
    _close(logits_t, logits_r, "decode past the table")
    _check_cache(cache_r, cache_t, "decode past the table")
    assert cache_t["len"] == n + 1
    assert torch.equal(logits_t, at_last)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("weights", [False, True])
def test_loss_and_gradients_match_jax_grad_f64(reference_in_f64, remat, weights):
    model_r, params, model_t = _pair(dtype="float64", remat=remat)
    model_t.requires_grad_(True)
    cfg = model_t.cfg
    rng = np.random.default_rng(5)
    B, S = 2, 40
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
        "extra_embeds": _frames(rng, B, cfg, np.float64),
    }
    batch["labels"][0, :5] = -100  # ignored positions
    if weights:
        batch["loss_weights"] = rng.random(B)
    (loss_r, aux_r), grads_r = jax.value_and_grad(model_r.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    loss_t, metrics = model_t.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss_t.backward()
    assert loss_t.dtype == torch.float64
    assert abs(loss_t.item() - float(loss_r)) <= 1e-12 * abs(float(loss_r))
    assert abs(metrics["nll"].item() - float(aux_r["nll"])) <= 1e-12 * abs(float(loss_r))
    assert float(metrics["moe_aux"]) == float(aux_r["moe_aux"]) == 0.0
    got = _flat(flat_to_reference(model_t, {n: p.grad for n, p in model_t.named_parameters()}))
    want = _flat(grads_r)
    assert set(got) == set(want)
    for name, g in want.items():
        assert _normwise(got[name], g) <= 1e-9, name
    # dec_pos rows past S get no gradient on either side
    assert not np.abs(_np64(got["dec_pos"])[S:]).any()


def test_weights_round_trip_and_refuse_missing_and_extra_arrays():
    cfg_r = r_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, r_get_model(cfg_r).init(jax.random.key(0)))
    cfg_t = ModelConfig.from_dict(dataclasses.asdict(cfg_r))
    model = from_reference(cfg_t, tree, "cpu")
    back = _flat(to_reference(model))
    assert set(back) == set(_flat(tree))
    for name, w in _flat(tree).items():
        assert np.array_equal(back[name].numpy(), w), name
    for stack, name in (("enc", "w_in"), ("dec", "x_wk")):
        missing = dict(tree, **{stack: {k: v for k, v in tree[stack].items() if k != name}})
        with pytest.raises(KeyError, match=name):
            from_reference(cfg_t, missing, "cpu")
    with pytest.raises(KeyError, match="dec_pos"):
        from_reference(cfg_t, {k: v for k, v in tree.items() if k != "dec_pos"}, "cpu")
    with pytest.raises(KeyError, match="extra"):
        from_reference(cfg_t, dict(tree, extra=np.zeros(3)), "cpu")
    with pytest.raises(KeyError, match="x_extra"):
        from_reference(cfg_t, dict(tree, dec=dict(tree["dec"], x_extra=np.zeros(3))), "cpu")


def test_npz_checkpoint_round_trip(tmp_path):
    """The port writes the reference's format: `repro`'s ``restore_step``
    reads it into the reference's tree, and the port reads it back."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    save_step(str(tmp_path), 7, to_reference(model))
    like = r_get_model(r_smoke_config(ARCH)).init(jax.random.key(0))
    tree, step = r_restore_step(str(tmp_path), like)
    assert step == 7
    back = from_reference(cfg, jax.tree.map(np.asarray, tree), "cpu")
    for (n, p), (_, q) in zip(model.named_parameters(), back.named_parameters()):
        assert p.dtype == q.dtype == torch.bfloat16 and torch.equal(p, q), n


def test_init_and_parameter_count():
    """The reference's scales (0.02; 0.005 for the output projections;
    0.01 for the position tables; LayerNorm scales one, biases zero) and
    its analytic count, which leaves out ``dec_pos`` and counts fewer
    LayerNorm vectors than the layers hold: two an encoder layer of four,
    three a decoder layer of six, none of the four final ones."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert tuple(model.dec_pos.shape) == (DEC_POSITIONS, cfg.d_model)
    assert tuple(model.enc_pos.shape) == (cfg.encoder_positions, cfg.d_model)
    assert abs(model.dec_pos.std().item() - 0.01) < 1e-3
    assert abs(model.enc_pos.std().item() - 0.01) < 1e-3
    for blk in (model.enc[0], model.dec[0]):
        assert torch.equal(blk.ln, torch.ones_like(blk.ln))
        assert torch.equal(blk.mln_b, torch.zeros_like(blk.mln_b))
        assert abs(blk.wq.std().item() - 0.02) < 2e-3
        assert abs(blk.w_out.std().item() - 0.005) < 5e-4
    assert abs(model.dec[0].x_wo.std().item() - 0.005) < 5e-4
    for c in (cfg, get_config(ARCH)):
        norms = (2 * c.encoder_layers + 3 * c.n_layers + 4) * c.d_model
        held = sum(p.numel() for p in Whisper(c, "meta").parameters())
        assert c.param_count() == held - DEC_POSITIONS * c.d_model - norms
    assert (get_config(ARCH).param_count(), held) == (759_411_712, 793_093_120)
