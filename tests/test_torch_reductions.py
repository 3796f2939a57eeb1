"""The port's streaming reductions against `repro.methods.reductions`.

`Reduction` is copied (validation, keys, hashing) and `reduce_trace` is
the same numpy code, so both must agree exactly. The in-loop fold is
written over a runs axis in torch; at float64 it must equal the
reference's in-scan fold (`repro`'s `run_serial`/`run_batch` with
``reductions=``) to 1e-12 — the continuous summaries normwise per key,
and the discrete ones (budget indices, time-to-target, the quantile
sketch) exactly — for every method name and both clock axes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.experiments as rx
import repro.methods as rm
import repro_torch.experiments as tx
import repro_torch.methods as tm
from repro.core.admm import Trace as RTrace
from repro_torch.core.admm import Trace as TTrace

CPU64 = dict(device="cpu", dtype=torch.float64)
ITERS = 40
TOL = 1e-12
FULL = dict(
    fields=("accuracy", "test_error", "z_err"),
    budgets=(0.005, 0.05, 0.2),
    x="sim_time",
    targets=(0.5, 0.2),
    quantiles=(0.1, 0.5, 0.9),
    final_x=True,
)
# One case per method name (a-csI-ADMM with three arms of the frontier).
METHOD_KW = {
    "sI-ADMM": dict(),
    "csI-ADMM": dict(S=1, scheme="cyclic"),
    "I-ADMM": dict(),
    "W-ADMM": dict(),
    "D-ADMM": dict(rho=0.1),
    "DGD": dict(),
    "EXTRA": dict(),
    "pI-ADMM": dict(sigma=0.05, S=1, scheme="cyclic"),
    "cq-sI-ADMM": dict(compressor="quant", bits=4),
    "a-csI-ADMM": dict(K=6, M=36, arms=(
        ("cyclic", 1, None), ("cyclic", 2, None), ("approx", 2, 3e-4))),
}


def specs(**kw):
    """The same Reduction in both packages."""
    return rm.Reduction(**{**FULL, **kw}), tm.Reduction(**{**FULL, **kw})


def _materialize(case, pkg):
    from importlib import import_module

    core = import_module(f"{pkg}.core")
    kernel = import_module(f"{pkg}.methods").get_kernel(case.method)
    net = core.make_network(case.N, case.connectivity, seed=case.seed)
    prob = core.allocate(core.DATASETS[case.dataset](case.seed), case.N, case.K)
    return kernel, prob, net, kernel.config(case)


def assert_summaries_close(got, want, tol=TOL, label=""):
    """Each key: the same shape; finite entries within ``tol`` of the
    key's largest magnitude, infinities equal (time_to never reached)."""
    assert set(got) == set(want), label
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, f"{label} {k}"
        assert np.array_equal(np.isinf(a), np.isinf(b)), f"{label} {k}"
        fin = np.isfinite(b)
        if fin.any():
            scale = max(np.abs(b[fin]).max(), 1e-300)
            gap = np.abs(a[fin] - b[fin]).max()
            assert gap <= tol * scale, f"{label} {k}: {gap:.3e} / {scale:.3e}"


def test_spec_validation_and_keys_match_reference():
    for kw in (dict(fields=("bogus",)), dict(fields=()), dict(x="iterations"),
               dict(budgets=(0.0,)), dict(quantiles=(1.5,)),
               dict(quantiles=(0.5,), lo=1.0, hi=1.0)):
        msgs = []
        for mod in (rm, tm):
            with pytest.raises(ValueError) as err:
                mod.Reduction(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], kw
    for kw in (dict(), FULL, dict(FULL, final_x=False, targets=()),
               dict(fields=("z_err",), quantiles=(1.0,))):
        r, t = rm.Reduction(**kw), tm.Reduction(**kw)
        assert r.keys() == t.keys() and r.axis_index == t.axis_index
        assert dataclasses.astuple(r) == dataclasses.astuple(t)
        assert hash(t) == hash(dataclasses.replace(t))
    assert tm.METRIC_FIELDS == rm.METRIC_FIELDS


def test_reduce_trace_equals_reference():
    rng = np.random.default_rng(0)
    n = 50
    fields = dict(
        accuracy=np.abs(rng.normal(size=n)),
        test_error=rng.random(n) * 3,
        comm_cost=np.cumsum(np.ones(n)),
        sim_time=np.cumsum(rng.random(n) * 1e-2),
        z_err=rng.random(n),
        final_x=rng.normal(size=(3, 2, 1)),
        final_z=rng.normal(size=(2, 1)),
    )
    rt, tt = RTrace(**fields), TTrace(**fields)
    for x in ("sim_time", "comm_cost"):
        r, t = specs(x=x, budgets=(0.01, 0.1, 40.0), targets=(0.5, 0.2, 1e-9))
        want, got = rt.reduce(r), tt.reduce(t)
        assert list(got) == list(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(got["accuracy/time_to"][-1:], [np.inf])


def test_fold_matches_reduce_trace_on_a_planted_trace():
    """The fold alone, on planted metrics: budgets before the first
    completion hold the first value, an unreached target stays +inf, and
    the sketch median lands where the numpy reference puts it."""
    spec = tm.Reduction(
        fields=("accuracy",), budgets=(0.5, 2.5, 9.0),
        targets=(0.65, 0.05), quantiles=(0.5,), bins=10, lo=0.0, hi=1.0,
    )
    acc = torch.tensor([[0.9, 0.6, 0.3, 0.1]], dtype=torch.float64)
    carry = spec.init_carry(1, torch.float64, "cpu")
    for k in range(4):
        carry = spec.update_carry(
            carry, (acc[:, k], acc[:, k], acc[:, k]),
            torch.ones((1, 2), dtype=torch.float64),
        )
    out = {k: v[0].numpy() for k, v in spec.finalize_carry(carry).items()}
    tr = TTrace(
        accuracy=acc[0].numpy(), test_error=acc[0].numpy(),
        comm_cost=np.arange(1.0, 5.0), sim_time=np.arange(1.0, 5.0),
        z_err=acc[0].numpy(), final_x=np.zeros((2, 2, 1)),
        final_z=np.zeros((2, 1)),
    )
    assert_summaries_close(out, tr.reduce(spec))
    np.testing.assert_allclose(out["accuracy/at_budget"], [0.9, 0.6, 0.1])
    np.testing.assert_array_equal(out["accuracy/time_to"], [2.0, np.inf])
    np.testing.assert_allclose(out["accuracy/quantiles"], [0.35])


@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_fold_matches_reference_in_scan_fold(method):
    """run_serial and run_batch with reductions= against the reference's
    in-scan fold on the same runs, both clock axes, at 1e-12."""
    kw = {
        **dict(method=method, dataset="usps", N=5, K=3, M=30, iters=30,
               seed=1, p_straggle=0.3),
        **METHOD_KW[method],
    }
    rc, tc = rx.Case(**kw), tx.Case(**kw)
    rk, rp, rn, rcfg = _materialize(rc, "repro")
    tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
    for x in ("sim_time", "comm_cost"):
        r, t = specs(x=x)
        # The reference's batched fold (its serial one agrees to 1e-12).
        want = rm.run_batch(rk, [rp] * 2, [rn] * 2, [rcfg] * 2, rc.iters,
                            reductions=r)
        gotb = tm.run_batch(tk, [tp] * 2, [tn] * 2, [tcfg] * 2, tc.iters,
                            reductions=t, **CPU64)
        assert_summaries_close(gotb, want, label=f"batch {x}")
        got = tm.run_serial(tk, tp, tn, tcfg, tc.iters, reductions=t, **CPU64)
        assert_summaries_close(
            got, {k: v[0] for k, v in want.items()}, label=f"serial {x}"
        )
        # And the fold against the port's own materialized trace.
        tr = tm.run_serial(tk, tp, tn, tcfg, tc.iters, **CPU64)
        assert_summaries_close(got, tr.reduce(t), label=f"post-hoc {x}")


def test_max_statics_bound_matches_reference_and_prepare():
    for M, S, scheme in ((60, 0, "uncoded"), (60, 1, "cyclic"),
                         (120, 1, "cyclic")):
        kw = dict(method="csI-ADMM", dataset="usps", N=5, K=3, M=M, S=S,
                  scheme=scheme, iters=10)
        rk, rp, rn, rcfg = _materialize(rx.Case(**kw), "repro")
        tk, tp, tn, tcfg = _materialize(tx.Case(**kw), "repro_torch")
        bound = tk.max_statics_bound(tp, tcfg, 10)
        assert bound == rk.max_statics_bound(rp, rcfg, 10)
        assert bound == tk.prepare(tp, tn, tcfg, 10).max_statics
    assert tm.get_kernel("DGD").max_statics_bound(None, None, 10) == {}


def test_sweep_streaming_all_modes_match_reference():
    """run_sweep with the spec's own Reduction: serial, batched and
    sharded (three CPU devices) against the reference's batched sweep."""
    def spec(mod):
        return mod.SweepSpec(
            "stream_smoke",
            mod.Case(method="csI-ADMM", dataset="usps", N=5, K=6, M=36,
                     scheme="cyclic", iters=ITERS),
            axes={"S": [0, 1, 2], "seed": [0, 1]},
            fixup=lambda c: dataclasses.replace(
                c, scheme="uncoded" if c.S == 0 else c.scheme),
            reductions=mod.Reduction(**FULL),
        )

    ref = rx.run_sweep(spec(rx), mode="batched")
    for mode in ("serial", "batched", "sharded"):
        res = tx.run_sweep(spec(tx), mode=mode, devices=["cpu"] * 3, **CPU64)
        assert res.traces == [] and res.n_dispatches == 1
        assert res.n_devices == (3 if mode == "sharded" else 1)
        assert_summaries_close(res.reduced, ref.reduced, label=mode)


def test_streamed_reduce_mean_and_emit_rows():
    spec = tx.get_sweep("fleet_frontier", iters=10, runs=2)
    res = tx.run_sweep(spec, **CPU64)
    ref = rx.run_sweep(rx.get_sweep("fleet_frontier", iters=10, runs=2),
                       mode="batched")
    for by, field in ((("scheme", "S"), "accuracy"),
                      (("scheme",), "accuracy/at_budget"),
                      (("response",), "test_error/quantiles")):
        got, want = tx.reduce_mean(res, by, field), rx.reduce_mean(ref, by, field)
        assert list(got) == list(want)
        for key in want:
            assert got[key]["n"] == want[key]["n"]
            np.testing.assert_allclose(got[key]["mean"], want[key]["mean"],
                                       rtol=1e-12, atol=1e-15)
    red = tx.reduce_mean(res, ("scheme", "S"), "accuracy")
    assert all(r["n"] == 4 and r["mean"].shape == () for r in red.values())
    with pytest.raises(KeyError, match="not in the streamed reduction"):
        tx.reduce_mean(res, by=("S",), field="bogus")

    class Rows:
        def __init__(self):
            self.rows = []

        def add(self, name, us, derived):
            self.rows.append((name, us, derived))

    rows = Rows()
    out = tx.emit_rows(res, rows, "sweep/fleet_frontier", ("scheme", "S"),
                       x="sim_time")
    assert len(rows.rows) == len(out) == 6
    assert all("sim_time_budget" not in r[2] for r in rows.rows)
    assert all("final_accuracy=" in r[2] for r in rows.rows)
