"""The port's models against the reference's: serving (prefill, decode)
for the dense, MoE, VLM, hybrid and ssm families.

`repro` builds each smoke model and initialises it with
``init(jax.random.key(0))``; `repro_torch.models.from_reference` carries
those weights into the port. Both then prefill the same numpy tokens and
run 4 teacher-forced decode steps (the same numpy tokens fed to both,
whatever either would pick), and every output is compared: prefill
logits, the whole cache (k, v, lru, conv, tail_*, len) and the logits of
each decode step. Argmax tokens are not compared: near-ties flip them.

Pairings: the port's ``"kernel"`` path (the kernels' plain versions on the
CPU) against the reference's ``"pallas"`` path (Pallas in interpret mode),
and the port's ``"plain"`` path against the reference's ``"jnp"`` path.
One case per family has S = 2048 > 1024, so the blocked (online-softmax)
attention is compared too. The vision-stub model (qwen2-vl) and the
audio-stub model (whisper, whose attention is the plain path on either
route) get the same numpy ``extra_embeds`` in both prefills; the MoE smoke configs route
through ``moe_apply`` (tests/test_torch_moe.py holds its routing bit for
bit).

Tolerance: the smoke configs are float32 and both sides compute norms,
RoPE, scores and the recurrence in float32, in different orders, so each
output is held normwise at float32 level:
max |port - ref| <= 1e-5 * max(max |ref|, 1) (measured: about 2e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke_config
from repro.models import get_model as r_get_model
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import ModelConfig, from_reference, get_model
from repro_torch.models.registry import empty_model

RTOL = 1e-5
DECODE_STEPS = 4
REF_IMPL = {"kernel": "pallas", "plain": "jnp"}


def _close(got, want, what):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    gap = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1.0)
    assert gap <= RTOL * scale, f"{what}: gap {gap:.3e} > {RTOL:.0e} x {scale:.3e}"


def _pair(arch, impl, **overrides):
    cfg_r = dataclasses.replace(
        r_smoke_config(arch), attn_impl=REF_IMPL[impl], ssm_impl=REF_IMPL[impl], **overrides
    )
    model_r = r_get_model(cfg_r)
    params = model_r.init(jax.random.key(0))
    cfg_t = ModelConfig.from_dict(dataclasses.asdict(cfg_r))
    assert cfg_t.attn_impl == impl and cfg_t.ssm_impl == impl
    model_t = from_reference(cfg_t, jax.tree.map(np.asarray, params), "cpu")
    return model_r, params, model_t


def _check_cache(cache_r, cache_t, what):
    assert set(cache_r) == set(cache_t), (sorted(cache_r), sorted(cache_t))
    assert int(cache_r["len"]) == cache_t["len"]
    for key in cache_r:
        if key != "len":
            _close(cache_t[key], cache_r[key], f"{what} cache[{key}]")


# (arch, impl, B, S): S = 70 wraps recurrentgemma's and mixtral's 64-slot
# window rings.
CASES = [
    ("qwen3-0.6b", "kernel", 2, 24),
    ("qwen3-0.6b", "plain", 2, 24),
    ("recurrentgemma-9b", "kernel", 2, 70),
    ("recurrentgemma-9b", "plain", 2, 70),
    ("qwen3-0.6b", "plain", 1, 2048),
    ("recurrentgemma-9b", "plain", 1, 2048),
    # S = 70 is ragged against mamba2's 32-step chunk (dt = 0 padding)
    ("mamba2-1.3b", "kernel", 2, 70),
    ("mamba2-1.3b", "plain", 2, 70),
    ("phi3.5-moe-42b-a6.6b", "kernel", 2, 24),
    ("phi3.5-moe-42b-a6.6b", "plain", 2, 24),
    ("mixtral-8x22b", "kernel", 2, 70),
    ("mixtral-8x22b", "plain", 2, 70),
    ("qwen2-vl-72b", "kernel", 2, 24),
    ("qwen2-vl-72b", "plain", 2, 24),
    ("llama3-405b", "kernel", 2, 24),
    ("stablelm-1.6b", "plain", 2, 24),
    ("internlm2-20b", "kernel", 2, 24),
    ("whisper-medium", "kernel", 2, 24),
    ("whisper-medium", "plain", 1, 2048),
]


@pytest.mark.parametrize("arch,impl,B,S", CASES)
def test_prefill_and_decode_match_reference(arch, impl, B, S):
    model_r, params, model_t = _pair(arch, impl)
    rng = np.random.default_rng(S + B)
    vocab = model_t.cfg.vocab
    tokens = rng.integers(0, vocab, (B, S), dtype=np.int32)
    kw_r, kw_t = {}, {}
    stub = {"vision_stub": 16, "audio_stub": model_t.cfg.encoder_positions}
    if model_t.cfg.modality in stub:
        ee = rng.standard_normal(
            (B, stub[model_t.cfg.modality], model_t.cfg.d_model)).astype(np.float32)
        kw_r, kw_t = {"extra_embeds": jnp.asarray(ee)}, {"extra_embeds": torch.from_numpy(ee)}
    logits_r, cache_r = model_r.prefill(
        params, jnp.asarray(tokens), extra_slots=DECODE_STEPS, **kw_r
    )
    logits_t, cache_t = model_t.prefill(
        torch.from_numpy(tokens), extra_slots=DECODE_STEPS, **kw_t
    )
    _close(logits_t, logits_r, "prefill logits")
    _check_cache(cache_r, cache_t, "prefill")
    decode_r = jax.jit(model_r.decode)
    for step in range(DECODE_STEPS):
        tok = rng.integers(0, vocab, (B, 1), dtype=np.int32)
        logits_r, cache_r = decode_r(params, cache_r, jnp.asarray(tok))
        logits_t, cache_t = model_t.decode_step(cache_t, torch.from_numpy(tok))
        _close(logits_t, logits_r, f"decode step {step} logits")
    _check_cache(cache_r, cache_t, "after decode")


def test_config_from_reference_dict_maps_impls():
    for arch in ARCHS:
        d = dataclasses.asdict(r_smoke_config(arch))
        cfg = ModelConfig.from_dict(d)
        assert (cfg.attn_impl, cfg.ssm_impl) == ("plain", "plain")  # "jnp"
        plain = dict(attn_impl="plain", ssm_impl="plain")
        assert cfg == dataclasses.replace(get_smoke_config(arch), **plain)
        d.update(attn_impl="pallas", ssm_impl="pallas")
        assert ModelConfig.from_dict(d).attn_impl == "kernel"
    full = get_config("qwen3-0.6b")
    assert (full.attn_impl, full.ssm_impl, full.torch_dtype) == ("kernel", "kernel", torch.bfloat16)
    assert (full.d_head, full.q_per_kv) == (128, 2)
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(full, attn_impl="pallas").validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    from repro.configs import get_config as r_get_config

    pairs = (
        (get_config(arch), r_get_config(arch)),
        (get_smoke_config(arch), r_smoke_config(arch)),
    )
    for ours, theirs in pairs:
        d = dataclasses.asdict(theirs)
        assert dataclasses.asdict(ours) == dict(d, attn_impl="kernel", ssm_impl="kernel")
        assert ours.param_count() == theirs.param_count()


def test_unported_archs_and_families_raise():
    """Every arch of the reference is ported; an unknown arch or family
    raises."""
    from repro.configs import ARCHS as R_ARCHS

    assert set(R_ARCHS) == set(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("gpt-2")
    other = ModelConfig(name="a", family="diffusion", n_layers=1, d_model=8, vocab=8,
                        n_heads=2, n_kv_heads=1, d_ff=8)
    with pytest.raises(NotImplementedError, match="unknown model family"):
        empty_model(other, "cpu")


def test_from_reference_rejects_missing_and_extra_arrays():
    cfg_r = r_smoke_config("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, r_get_model(cfg_r).init(jax.random.key(0)))
    cfg_t = ModelConfig.from_dict(dataclasses.asdict(cfg_r))
    missing = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "wq"})
    with pytest.raises(KeyError, match="wq"):
        from_reference(cfg_t, missing, "cpu")
    with pytest.raises(KeyError, match="extra"):
        from_reference(cfg_t, dict(tree, extra=np.zeros(3)), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_reference_scales(arch):
    """Random init at the reference's scales and constants, from an
    explicit generator: the same seed gives the same weights."""
    cfg = get_smoke_config(arch)
    a = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
        assert not pa.requires_grad
    assert abs(a.embed.std().item() - 0.02) < 2e-3
    if arch == "mamba2-1.3b":
        blk = a.layers[0]
        ref = r_get_model(r_smoke_config(arch)).init(jax.random.key(0))["layers"]
        for name in ("A_log", "dt_bias", "D_skip"):  # exact, float32
            assert getattr(blk, name).dtype == torch.float32
            assert np.array_equal(getattr(blk, name).numpy(), np.asarray(ref[name][0])), name
        assert abs(blk.conv_w.std().item() - 0.2) < 0.03
        assert abs(blk.w_out.std().item() - 0.02 / cfg.n_layers**0.5) < 2e-3
    elif arch == "recurrentgemma-9b":
        blk = a.rec[0][0]
        assert torch.equal(blk.lru_ba, torch.full_like(blk.lru_ba, 2.0))
        assert torch.equal(getattr(blk, "lambda"), torch.ones_like(blk.lru_ba))
        assert blk.lru_ba.dtype == torch.float32
        assert abs(blk.conv_w.std().item() - 0.2) < 0.03
    elif arch == "whisper-medium":  # tests/test_torch_whisper.py holds the rest
        blk = a.dec[0]
        assert torch.equal(blk.x_ln, torch.ones_like(blk.x_ln))
        assert abs(blk.x_wo.std().item() - 0.005) < 5e-4
    else:
        L = cfg.n_layers
        blk = a.layers[0]
        assert abs(blk.wo.std().item() - 0.02 / L**0.5) < 2e-3
        assert torch.equal(blk.ln1, torch.zeros_like(blk.ln1))
        assert abs(blk.w_down.std().item() - 0.02 / L**0.5) < 2e-3
        if cfg.family == "moe":
            E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
            assert tuple(blk.router.shape) == (D, E) and tuple(blk.w_down.shape) == (E, F, D)
            assert abs(blk.router.std().item() - 0.02) < 3e-3
        assert hasattr(a, "vis_proj") == (cfg.modality == "vision_stub")
        if cfg.modality == "vision_stub":
            assert abs(a.vis_proj.std().item() - 0.02) < 2e-3
