"""The port's sweep engine against `repro.experiments`, end to end.

Every ported sweep at smoke scale (``iters=120, runs=2``; the gossip
groups of the baseline sweeps run 12 iterations) runs through the port's
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
}
PORTED = sorted(BY) + ["fig3_minibatch", "fig4_stragglers"]
UNPORTED = ["fleet_frontier", "adaptive_frontier", "staleness_frontier", "churn_grid"]


def _same_grid(a, b):
    assert [dataclasses.astuple(c) for c in a] == [dataclasses.astuple(c) for c in b]
    assert [hash(c) for c in a] == [hash(c) for c in b]
    assert [c.label("S", "seed") for c in a] == [c.label("S", "seed") for c in b]


@pytest.mark.parametrize("name", list(BY))
def test_sweep_matches_reference_per_case(name):
    ref = rx.run_sweep(rx.get_sweep(name, iters=120, runs=2), mode="batched")
    got = tx.run_sweep(tx.get_sweep(name, iters=120, runs=2), **CPU64)
    _same_grid(got.cases, ref.cases)
    assert got.groups == ref.groups and got.mode == "batched"
    assert got.device == "cpu"
    for case, g, r in zip(got.cases, got.traces, ref.traces):
        for f in FIELDS:
            np.testing.assert_allclose(
                getattr(g, f), np.asarray(getattr(r, f)),
                err_msg=f"{case.label('S', 'scheme', 'seed')} {f}", **TOL,
            )
        assert np.array_equal(g.comm_cost, r.comm_cost)
        assert np.array_equal(g.sim_time, r.sim_time)
    # The per-cell reduction the figures plot agrees too.
    by = BY[name]
    rr, gr = rx.reduce_mean(ref, by), tx.reduce_mean(got, by)
    assert list(rr) == list(gr)
    for key in rr:
        np.testing.assert_allclose(gr[key]["mean"], rr[key]["mean"], **TOL)
        np.testing.assert_allclose(gr[key]["ci"], rr[key]["ci"], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", PORTED)
def test_ported_registry_specs_expand_alike(name):
    for kw in (dict(), dict(iters=30, runs=3)):
        r, t = rx.get_sweep(name, **kw), tx.get_sweep(name, **kw)
        assert (r.name, r.description, r.x_axis) == (t.name, t.description, t.x_axis)
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


def test_unknown_and_unported_sweeps_and_modes():
    assert sorted(tx.SWEEPS) == sorted(PORTED)
    assert sorted(rx.SWEEPS) == sorted(PORTED + UNPORTED)
    for name in UNPORTED:
        with pytest.raises(KeyError, match="ported: .*fig3_minibatch.*fig5"):
            tx.get_sweep(name)
    spec = tx.get_sweep("fig5", iters=10, runs=1)
    with pytest.raises(NotImplementedError, match="item 13"):
        tx.run_sweep(spec, mode="sharded", **CPU64)
    with pytest.raises(NotImplementedError, match="item 10"):
        tx.run_sweep(spec, reductions=object(), **CPU64)
    with pytest.raises(ValueError, match="unknown sweep mode"):
        tx.run_sweep(spec, mode="vmap", **CPU64)
    with pytest.raises(ValueError, match="empty sweep"):
        tx.run_sweep([], **CPU64)
    with pytest.raises(KeyError, match="unknown dataset"):
        tx.run_sweep([tx.Case(dataset="mnist", iters=5)], **CPU64)
