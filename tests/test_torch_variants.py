"""The port's ADMM variants (pI-ADMM, cq-sI-ADMM) against `repro` and
against sI-ADMM.

The control arms are sI-ADMM bit for bit: pI-ADMM at sigma = 0 adds
exact zeros to the shared primal, and cq-sI-ADMM's top-k at frac = 1
keeps every entry, so the error-feedback residual stays exactly zero. In
the port both run the same eager step as sI-ADMM, so the traces are
compared with `np.array_equal`, not a tolerance (the reference allows
ULP-level gaps for its separately fused executables, tests/test_methods.py).

The compressors are held to the reference's on the same inputs, one run
per row of the port's runs axis: top-k with planted ties (the lower index
wins, as in `jax.lax.top_k`) and stochastic quantization with a per-run
scale, a zero-scale run included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.methods as rm
import repro_torch.methods as tm
from repro_torch.methods.compression import topk_mask

from test_torch_methods import ITERS, _cases, _materialize

FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z")


def _port_trace(method, dtype=torch.float64, **kw):
    _, tc = _cases(method, **kw)
    k, p, n, cfg = _materialize(tc, "repro_torch")
    return tm.run_serial(k, p, n, cfg, ITERS, device="cpu", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method,kw", [
    ("pI-ADMM", dict(sigma=0.0)),
    ("cq-sI-ADMM", dict(compressor="topk", frac=1.0)),
])
def test_control_arm_is_exactly_siadmm(method, kw, dtype):
    got = _port_trace(method, dtype, S=0, scheme="uncoded", **kw)
    want = _port_trace("sI-ADMM", dtype)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    # A full top-k token still ships its indices: it costs more per hop
    # (and its link time scales with that); the noise costs nothing.
    same_cost = method == "pI-ADMM"
    for f in ("comm_cost", "sim_time"):
        assert np.array_equal(getattr(got, f), getattr(want, f)) == same_cost, f


def test_topk_ties_pick_the_lower_index_as_jax():
    rng = np.random.default_rng(0)
    # Rows of few distinct magnitudes, signs mixed: most entries tie.
    u = rng.integers(-3, 4, size=(6, 40)).astype(np.float64)
    u[1] = 0.0  # all tied at zero
    u[2, ::2] = -u[2, 1::2]  # pairs of equal magnitude, opposite sign
    for k in (1, 5, 13, 40):
        got = topk_mask(torch.as_tensor(u), k).numpy()
        for r in range(u.shape[0]):
            _, idx = jax.lax.top_k(jnp.abs(jnp.asarray(u[r])), k)
            want = np.zeros(u.shape[1])
            want[np.asarray(idx)] = 1.0
            assert np.array_equal(got[r], want), (k, r)


@pytest.mark.parametrize("compressor", ["topk", "quant"])
def test_token_increment_matches_reference_run_by_run(compressor):
    """One call of the port's hook on R runs == R calls of the
    reference's, including the carried residual."""
    R, p, d = 4, 6, 3
    rng = np.random.default_rng(1)
    dz = np.round(rng.standard_normal((R, p, d)), 1)  # ties in |u|
    e = np.round(0.1 * rng.standard_normal((R, p, d)), 2)
    dz[3], e[3] = 0.0, 0.0  # a run with zero scale
    unif = rng.random((R, p, d))
    statics = dict(compressor=compressor, k_keep=5, levels=15)
    inp = (None,) * 6 + (torch.as_tensor(unif),)
    upd, c = tm.get_kernel("cq-sI-ADMM")._token_increment(
        dict(e=torch.as_tensor(e)), torch.as_tensor(dz), inp, None, statics
    )
    rk = rm.get_kernel("cq-sI-ADMM")
    for r in range(R):
        rupd, rc = rk._token_increment(
            dict(e=jnp.asarray(e[r])), jnp.asarray(dz[r]),
            (None,) * 6 + (jnp.asarray(unif[r]),), None, statics,
        )
        np.testing.assert_allclose(c[r].numpy(), np.asarray(rc), rtol=1e-15, atol=0)
        np.testing.assert_allclose(
            upd["e"][r].numpy(), np.asarray(rupd["e"]), rtol=1e-15, atol=0
        )


@pytest.mark.parametrize("bad,match", [
    (dict(frac=0.0), "frac must be in"),
    (dict(frac=1.5), "frac must be in"),
    (dict(compressor="quant", bits=0), "bits must be >= 1"),
    (dict(compressor="sketch"), "unknown compressor"),
])
def test_compression_rejects_bad_configs_as_the_reference(bad, match):
    msgs = []
    for pkg, case in zip(("repro", "repro_torch"), _cases("cq-sI-ADMM")):
        k, p, n, cfg = _materialize(case, pkg)
        run = dataclasses.replace(cfg, **bad)
        with pytest.raises(ValueError, match=match) as err:
            k.prepare(p, n, run, ITERS)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
