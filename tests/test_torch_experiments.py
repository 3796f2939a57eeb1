"""The port's sweep engine against `repro.experiments`, end to end.

Every sweep at smoke scale (``iters=120, runs=2``; the gossip groups of
the baseline sweeps run 12 iterations; the four sweeps of the streaming,
async and control layers ``iters=60, runs=1``) runs through the port's
`run_sweep` on the CPU in float64 and through the reference's batched
`run_sweep`; every case's trace must agree within rtol 1e-9 / atol 1e-12
(summation order only: the worst gap measured was 4.2e-13 relative on
fig5's test error and 9.3e-12 relative on a near-zero fig3_stragglers
final iterate; over the other eleven sweeps, at most 6e-4 of the
tolerance), and the grid, its grouping and the host clocks must be
identical — for the baselines' and variants' groups as for the ADMM
family's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.experiments as rx
import repro_torch.experiments as tx

TOL = dict(rtol=1e-9, atol=1e-12)
CPU64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z")
# The fields each sweep's figure averages over (its axes, seeds apart).
BY = {
    "fig5": ["S"],
    "fig3_stragglers": ["scheme", "epsilon"],
    "fig3_baselines": ["method"],
    "fig4_baselines": ["method"],
    "fig3e_runtime": ["method"],
    "privacy_grid": ["sigma", "S"],
    "compression_grid": ["compressor", "bits", "frac", "connectivity"],
    "topology_grid": ["connectivity", "S", "scheme"],
    "hetero_grid": ["speed_classes", "S", "scheme"],
    "code_frontier": ["scheme", "S", "deadline"],
    "mesh_scale": ["S", "scheme"],
    "fleet_frontier": ["response", "scheme", "S"],
    "staleness_frontier": ["method", "tau_max"],
    "churn_grid": ["scheme", "churn_rate"],
    "adaptive_frontier": ["bandit"],
}
# Smoke scale per sweep: the default, and that of the four newest.
SMOKE = {name: dict(iters=60, runs=1) for name in (
    "fleet_frontier", "staleness_frontier", "churn_grid", "adaptive_frontier")}
PORTED = sorted(BY) + ["fig3_minibatch", "fig4_stragglers"]
UNPORTED = []


def _same_grid(a, b):
    assert [dataclasses.astuple(c) for c in a] == [dataclasses.astuple(c) for c in b]
    assert [hash(c) for c in a] == [hash(c) for c in b]
    assert [c.label("S", "seed") for c in a] == [c.label("S", "seed") for c in b]


@pytest.mark.parametrize("name", list(BY))
def test_sweep_matches_reference_per_case(name):
    smoke = SMOKE.get(name, dict(iters=120, runs=2))
    ref = rx.run_sweep(rx.get_sweep(name, **smoke), mode="batched")
    got = tx.run_sweep(tx.get_sweep(name, **smoke), **CPU64)
    _same_grid(got.cases, ref.cases)
    assert got.groups == ref.groups and got.mode == "batched"
    assert got.device == "cpu" and got.n_devices == 1
    by = BY[name]
    if ref.reduced is not None:
        # A streamed sweep (fleet_frontier): summaries, no traces.
        assert got.traces == [] and set(got.reduced) == set(ref.reduced)
        for k, want in ref.reduced.items():
            want, have = np.asarray(want), got.reduced[k]
            assert have.shape == want.shape and have.shape[0] == len(got.cases)
            fin = np.isfinite(want)
            assert np.array_equal(np.isfinite(have), fin), k
            np.testing.assert_allclose(have[fin], want[fin], err_msg=k, **TOL)
        fields = ("accuracy", "accuracy/at_budget", "test_error/time_to")
    else:
        for case, g, r in zip(got.cases, got.traces, ref.traces):
            for f in FIELDS:
                np.testing.assert_allclose(
                    getattr(g, f), np.asarray(getattr(r, f)),
                    err_msg=f"{case.label('S', 'scheme', 'seed')} {f}", **TOL,
                )
            assert np.array_equal(g.comm_cost, r.comm_cost)
            assert np.array_equal(g.sim_time, r.sim_time)
        fields = ("accuracy",)
    # The per-cell reduction the figures plot agrees too.
    for field in fields:
        rr, gr = rx.reduce_mean(ref, by, field), tx.reduce_mean(got, by, field)
        assert list(rr) == list(gr)
        for key in rr:
            np.testing.assert_allclose(gr[key]["mean"], rr[key]["mean"], **TOL)
            np.testing.assert_allclose(gr[key]["ci"], rr[key]["ci"], rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("name", PORTED)
def test_ported_registry_specs_expand_alike(name):
    for kw in (dict(), dict(iters=30, runs=3)):
        r, t = rx.get_sweep(name, **kw), tx.get_sweep(name, **kw)
        assert (r.name, r.description, r.x_axis) == (t.name, t.description, t.x_axis)
        assert (r.reductions is None) == (t.reductions is None)
        if t.reductions is not None:
            assert dataclasses.astuple(r.reductions) == dataclasses.astuple(
                t.reductions)
        _same_grid(t.cases(), r.cases())


def test_fig4_stragglers_runs_at_smoke_scale():
    ref = rx.run_sweep(rx.get_sweep("fig4_stragglers", iters=30), mode="batched")
    got = tx.run_sweep(tx.get_sweep("fig4_stragglers", iters=30), **CPU64)
    for g, r in zip(got.traces, ref.traces):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(g, f), np.asarray(getattr(r, f)), **TOL)


def test_serial_mode_and_result_helpers():
    spec = tx.get_sweep("fig3_minibatch", iters=25, runs=1)
    batched = tx.run_sweep(spec, **CPU64)
    serial = tx.run_sweep(spec, mode="serial", **CPU64)
    assert serial.mode == "serial" and batched.n_dispatches == 1
    for a, b in zip(serial.traces, batched.traces):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), **TOL)
    assert batched.trace(M=30, seed=0) is batched.traces[1]
    with pytest.raises(KeyError, match="matched 4 cases"):
        batched.trace(seed=0)
    assert len(batched.select(seed=0)) == 4
    stacked = tx.stack_field(batched.traces, "accuracy")
    assert stacked.shape == (4, 25)
    grid, vals = tx.resample_runs(tx.stack_field(batched.traces, "sim_time"), stacked, 20)
    rgrid, rvals = rx.resample_runs(tx.stack_field(batched.traces, "sim_time"), stacked, 20)
    assert np.array_equal(grid, rgrid) and np.array_equal(vals, rvals)
    assert all(np.array_equal(a, b) for a, b in zip(
        tx.mean_ci(stacked), rx.mean_ci(stacked)))

    class Rows:
        def __init__(self):
            self.rows = []

        def add(self, name, us, derived):
            self.rows.append((name, us, derived))

    rows = Rows()
    red = tx.emit_rows(batched, rows, "fig3a", by=["M"], x="sim_time")
    assert len(rows.rows) == len(red) == 4
    assert rows.rows[0][0] == "fig3a/sI-ADMM[M=6]"
    assert "runs=1" in rows.rows[0][2] and "sim_time_budget=" in rows.rows[0][2]


def test_unknown_and_unported_sweeps_and_modes(monkeypatch):
    assert sorted(tx.SWEEPS) == sorted(PORTED) == sorted(rx.SWEEPS)
    assert UNPORTED == []
    with pytest.raises(KeyError, match="unknown sweep .*fig3_minibatch.*fig5"):
        tx.get_sweep("fig6")
    spec = tx.get_sweep("fig5", iters=10, runs=1)
    with pytest.raises(ValueError, match="unknown sweep mode"):
        tx.run_sweep(spec, mode="vmap", **CPU64)
    with pytest.raises(ValueError, match="empty sweep"):
        tx.run_sweep([], **CPU64)
    with pytest.raises(KeyError, match="unknown dataset"):
        tx.run_sweep([tx.Case(dataset="mnist", iters=5)], **CPU64)
    # Groups that emit different summary keys cannot share a grid.
    from repro_torch.experiments import sweep as engine

    dispatch, calls = engine._dispatch_group, []

    def renamed_second_group(method, group, *args):
        calls.append(1)
        out = dispatch(method, group, *args)
        return {k + "'": v for k, v in out.items()} if len(calls) == 2 else out

    monkeypatch.setattr(engine, "_dispatch_group", renamed_second_group)
    cases = spec.cases()[:1]
    cases.append(dataclasses.replace(cases[0], K=3, M=60))
    with pytest.raises(ValueError, match="different reduction keys"):
        tx.run_sweep(cases, reductions=tx.Reduction(), **CPU64)
