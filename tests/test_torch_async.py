"""The port's event-driven mode against `repro` (the async ring paths).

Contracts, as in the reference's own async tests:

- **Bulk-synchronous equivalence**: ``tau_max = 0`` / ``churn_rate = 0``
  cells take the exact pre-async path — the same signature, steps and
  bits — inside a mixed sync/async sweep.
- **Degenerate asynchrony**: a vanishing staleness bound (every delay
  rounds to 0 steps) reproduces the synchronous iterates through the
  ring path, to round-off.
- **Churn -> alive mask -> decode**: crashed ECNs carry exactly zero
  decode weight (the host schedule is the reference's, bitwise), and NaN
  planted in dead message rows cannot leak through the fused combine.
- **Parity**: async sweeps on the port equal `repro`'s per case.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.experiments as rx
import repro_torch.experiments as tx
from repro.core.admm import ADMMConfig as RConfig, make_schedule as r_schedule
from repro.core.coding import make_code as r_code
from repro.core.graph import make_network as r_network
from repro.core.timing import TimingModel as RTiming
from repro_torch.core.admm import ADMMConfig, make_schedule
from repro_torch.core.coding import make_code
from repro_torch.core.graph import make_network
from repro_torch.core.timing import TimingModel
from repro_torch.kernels.ops import coded_admm_update, coded_combine

CPU64 = dict(device="cpu", dtype=torch.float64)
ITERS = 30
TOL = dict(rtol=1e-9, atol=1e-12)
FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z")


def _admm_case(mod, **kw):
    kw = {**dict(method="csI-ADMM", dataset="synthetic", K=6, M=360, S=1,
                 scheme="cyclic", iters=ITERS, p_straggle=0.3, delay=5e-3),
          **kw}
    return mod.Case(**kw)


def _gossip_case(mod, method, **kw):
    kw = {**dict(dataset="synthetic", iters=20, alpha=0.05, rho=0.1), **kw}
    return mod.Case(method=method, **kw)


CASES = {
    "csI-ADMM": lambda mod: _admm_case(mod),
    "cq-sI-ADMM": lambda mod: _admm_case(
        mod, method="cq-sI-ADMM", compressor="quant", bits=8),
    "pI-ADMM": lambda mod: _admm_case(mod, method="pI-ADMM", sigma=0.01),
    "DGD": lambda mod: _gossip_case(mod, "DGD"),
    "EXTRA": lambda mod: _gossip_case(mod, "EXTRA"),
    "D-ADMM": lambda mod: _gossip_case(mod, "D-ADMM"),
}


def _same(a, b, fields=FIELDS + ("sim_time", "comm_cost")):
    for f in fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("mode", ["serial", "batched"])
def test_sync_cell_bit_identical_inside_mixed_sweep(mode):
    """A tau_max = 0 cell inside a mixed sync/async grid produces the same
    bits as the standalone synchronous run, and keeps its own group."""
    sync = _admm_case(tx)
    ref = tx.run_sweep([sync], mode=mode, **CPU64).traces[0]
    res = tx.run_sweep([sync, dataclasses.replace(sync, tau_max=2e-3)],
                       mode=mode, **CPU64)
    assert res.n_dispatches == 2
    _same(res.traces[0], ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_degenerate_async_equals_sync(name):
    """tau_max so small every delay rounds to 0 steps: the ring path
    reproduces the synchronous iterates (the write lands in the step that
    reads it; act stays 1), to round-off — and equals the reference's
    degenerate run."""
    case = CASES[name](tx)
    sync = tx.run_sweep([case], mode="serial", **CPU64).traces[0]
    deg = dataclasses.replace(case, tau_max=1e-12)
    res = tx.run_sweep([deg], mode="serial", **CPU64)
    sig = res.groups[0][0]
    assert ("async", deg.staleness_cap) in zip(sig, sig[1:])
    tr = res.traces[0]
    np.testing.assert_allclose(tr.accuracy, sync.accuracy, rtol=1e-12)
    np.testing.assert_allclose(tr.test_error, sync.test_error, rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tr.final_z, sync.final_z, rtol=1e-12, atol=1e-15)
    ref = rx.run_sweep([dataclasses.replace(CASES[name](rx), tau_max=1e-12)],
                       mode="serial").traces[0]
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tr, f), np.asarray(getattr(ref, f)),
                                   err_msg=f, **TOL)


def _churned(cfg_cls, net_fn, code_fn, tm_cls, sched_fn, scheme="mds",
             churn_rate=40.0, mttr=0.02, iters=400):
    cfg = cfg_cls(M=360, K=6, S=2, scheme=scheme, seed=0)
    tm = tm_cls(p_straggle=0.3, delay=5e-3, churn_rate=churn_rate, mttr=mttr)
    return sched_fn(cfg, net_fn(6, 0.5, seed=0), code_fn(scheme, 6, 2, seed=0),
                    tm, iters, b=720)


@pytest.mark.parametrize("scheme,rate,mttr", [("mds", 40.0, 0.02),
                                              ("cyclic", 80.0, 0.0)])
def test_crashed_ecns_never_weighted(scheme, rate, mttr):
    """Censored ECNs carry exactly zero decode weight; undecodable survivor
    patterns become skipped activations; the schedule is the reference's
    bit for bit."""
    got = _churned(ADMMConfig, make_network, make_code, TimingModel,
                   make_schedule, scheme, rate, mttr)
    want = _churned(RConfig, r_network, r_code, RTiming, r_schedule,
                    scheme, rate, mttr)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert not got["alive"].all()  # churn actually bit
    assert np.all(got["decode"][~got["alive"]] == 0.0)
    assert np.all(got["decode"][got["act"] == 0.0] == 0.0)
    if scheme == "cyclic":
        undecodable = got["alive"].sum(axis=1) < make_code(
            "cyclic", 6, 2).min_responses
        assert undecodable.any() and np.all(got["act"][undecodable] == 0.0)


def test_nan_in_dead_rows_cannot_leak():
    """NaN planted in masked-out message rows never reaches the decoded
    combine, nor the fused x-update — the guarantee churn relies on."""
    rng = np.random.default_rng(0)
    R, J, n = 4, 6, 64
    msgs = torch.from_numpy(rng.normal(size=(R, J, n)))
    coeffs = torch.from_numpy(rng.normal(size=(R, J)))
    mask = torch.tensor([[1, 1, 0, 1, 0, 1]] * R, dtype=torch.float64)
    poisoned = msgs.clone()
    poisoned[mask == 0] = float("nan")
    clean = coded_combine(msgs, coeffs, mask)
    out = coded_combine(poisoned, coeffs, mask)
    assert torch.isfinite(out).all() and torch.equal(out, clean)
    x, y, z = (torch.from_numpy(rng.normal(size=(R, n))) for _ in range(3))
    tau, rho = torch.full((R,), 2.0, dtype=torch.float64), torch.ones(
        R, dtype=torch.float64)
    a = coded_admm_update(poisoned, coeffs, x, y, z, tau, rho, mask)
    b = coded_admm_update(msgs, coeffs, x, y, z, tau, rho, mask)
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_churned_run_stays_finite_and_matches_reference():
    """Heavy churn leaves iterates finite, MDS (any-R decode) beats cyclic
    under the same crash schedule, and both equal the reference's."""
    cases = {mod: [_admm_case(mod, S=2, churn_rate=25.0, mttr=0.05, iters=120)]
             for mod in (rx, tx)}
    for mod in (rx, tx):
        cases[mod].append(dataclasses.replace(cases[mod][0], scheme="mds"))
    got = tx.run_sweep(cases[tx], mode="batched", **CPU64)
    want = rx.run_sweep(cases[rx], mode="batched")
    assert got.groups == want.groups
    cyc, mds = got.traces
    assert np.isfinite(cyc.accuracy).all() and np.isfinite(mds.accuracy).all()
    assert mds.accuracy[-1] <= cyc.accuracy[-1] + 1e-9
    for g, w in zip(got.traces, want.traces):
        assert np.array_equal(g.sim_time, w.sim_time)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(g, f), np.asarray(getattr(w, f)),
                                       err_msg=f, **TOL)


def test_async_composes_with_streaming_reductions():
    """Event-driven runs flow through the in-loop Reduction fold: the
    summaries of churn_grid equal the reference's."""
    from test_torch_reductions import assert_summaries_close

    def spec(mod):
        return dataclasses.replace(
            mod.get_sweep("churn_grid", iters=24, runs=1),
            reductions=mod.Reduction(fields=("accuracy",), budgets=(0.5, 1.0),
                                     x="sim_time"),
        )

    res = tx.run_sweep(spec(tx), **CPU64)
    ref = rx.run_sweep(spec(rx), mode="batched")
    assert res.traces == [] and res.groups == ref.groups
    for v in res.reduced.values():
        assert np.isfinite(v).all()
    assert_summaries_close(res.reduced, ref.reduced, tol=1e-9)


def test_walkman_rejects_async_in_a_sweep():
    """W-ADMM has no event-driven mode: the reference's loud failure."""
    case = tx.Case(method="W-ADMM", dataset="synthetic", iters=10, tau_max=1e-3)
    with pytest.raises(NotImplementedError, match="event-driven"):
        tx.run_sweep([case], mode="serial", **CPU64)
