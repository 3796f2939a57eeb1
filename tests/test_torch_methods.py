"""The port's method kernels and drivers against `repro.methods`.

Host side: the port's ``prepare`` must equal the reference's bitwise.
Device side: the reference's own ``prepare`` output, converted by
`prepared_to_device`, runs through the port's step loop and must track
the reference's `run_serial`/`run_batch` traces — so a host-side and a
device-side difference cannot hide each other. All device work here is on
the CPU in float64.

Trajectory tolerance: rtol 1e-9, atol 1e-12. PyTorch's CPU matmul/einsum
sum in another order than XLA, and the ADMM iteration is contractive, so
the gap stays at round-off: measured on this suite's cases, the worst
elementwise gap was 8.3e-12 relative (a near-zero entry), 6e-4 of the
tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.experiments as rx
import repro.methods as rm
import repro_torch.experiments as tx
import repro_torch.methods as tm
from repro.core.admm import run_incremental_admm as r_run_incremental
from repro.methods import driver as r_driver
from repro_torch.core.admm import run_incremental_admm as t_run_incremental
from repro_torch.core.timing import TimingModel
from repro_torch.methods import driver as t_driver

ITERS = 40
TOL = dict(rtol=1e-9, atol=1e-12)
CPU64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z")
# Every ported method, one case each; a key that is not a method name
# names the method in its kwargs (a second case of the same kernel).
METHOD_KW = {
    "sI-ADMM": dict(),
    "csI-ADMM": dict(S=1, scheme="cyclic"),
    "I-ADMM": dict(),
    "W-ADMM": dict(),
    "D-ADMM": dict(rho=0.1),
    "DGD": dict(),
    "EXTRA": dict(),
    "pI-ADMM": dict(sigma=0.05, S=1, scheme="cyclic"),
    "cq-sI-ADMM": dict(compressor="topk", frac=0.25),
    "cq-sI-ADMM-quant": dict(method="cq-sI-ADMM", compressor="quant", bits=4),
    "a-csI-ADMM": dict(arms=(("cyclic", 1, None), ("cyclic", 2, None),
                             ("approx", 1, 3e-4))),
}
# Families the batch tests stack: each tuple batches into one group.
BATCH_FAMILIES = (
    ("sI-ADMM", "csI-ADMM"),
    ("W-ADMM",), ("D-ADMM",), ("DGD",), ("EXTRA",),
    ("pI-ADMM",), ("cq-sI-ADMM",), ("cq-sI-ADMM-quant",),
)


def _cases(method, seed=0, **kw):
    """The same run as a reference `Case` and a port `Case`."""
    kw = {
        **dict(method=method, dataset="usps", N=5, K=3, M=36, iters=ITERS,
               seed=seed, p_straggle=0.3),
        **METHOD_KW[method], **kw,
    }
    return rx.Case(**kw), tx.Case(**kw)


def _materialize(case, pkg):
    """(kernel, problem, net, cfg) of a case in package ``pkg``."""
    from importlib import import_module

    core = import_module(f"{pkg}.core")
    kernel = import_module(f"{pkg}.methods").get_kernel(case.method)
    net = core.make_network(case.N, case.connectivity, seed=case.seed)
    prob = core.allocate(core.DATASETS[case.dataset](case.seed), case.N, case.K)
    return kernel, prob, net, kernel.config(case)


def _assert_traces_close(got, want, **tol):
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f), np.asarray(getattr(want, f)), err_msg=f,
            **(tol or TOL),
        )
    for f in ("comm_cost", "sim_time"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_registry_holds_the_ported_family():
    assert sorted(tm.KERNELS) == sorted(
        ["sI-ADMM", "csI-ADMM", "I-ADMM", "W-ADMM", "D-ADMM", "DGD",
         "EXTRA", "pI-ADMM", "cq-sI-ADMM", "a-csI-ADMM"]
    )
    # sI/csI/I-ADMM are one instance; every other name is its own kernel.
    admm = {tm.get_kernel(m) for m in ("sI-ADMM", "csI-ADMM", "I-ADMM")}
    assert len(admm) == 1
    assert len({id(k) for k in tm.KERNELS.values()}) == 8
    assert set(tm.KERNELS) == set(rm.KERNELS)
    with pytest.raises(KeyError, match="unknown method"):
        tm.get_kernel("b-csI-ADMM")


@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_prepare_is_bitwise_the_reference(method):
    for seed in (0, 1):
        rc, tc = _cases(method, seed)
        rk, rp, rn, rcfg = _materialize(rc, "repro")
        tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
        assert rk.static_signature(rp, rcfg, ITERS) == tk.static_signature(
            tp, tcfg, ITERS
        )
        a = rk.prepare(rp, rn, rcfg, ITERS)
        b = tk.prepare(tp, tn, tcfg, ITERS)
        assert a.statics == b.statics and a.max_statics == b.max_statics
        for name in ("consts", "steps"):
            for x, y in zip(getattr(a, name), getattr(b, name), strict=True):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert np.array_equal(a.comm, b.comm)
        assert np.array_equal(a.sim_time, b.sim_time)


@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_reference_prepare_through_port_step_serial(method):
    """repro's prepare -> prepared_to_device -> the port's step loop ==
    repro's run_serial, per step and in the final iterates."""
    rc, _ = _cases(method)
    rk, rp, rn, rcfg = _materialize(rc, "repro")
    prep = rk.prepare(rp, rn, rcfg, ITERS)
    consts, steps = tm.prepared_to_device(
        *t_driver._stack([prep]), **CPU64
    )
    for host, dev in zip(prep.consts + prep.steps, consts + steps, strict=True):
        want = (torch.int64 if np.issubdtype(np.asarray(host).dtype, np.integer)
                else torch.float64)
        assert dev.dtype == want
    assert consts[0].dtype == torch.float64
    statics = {**prep.statics, **prep.max_statics}
    x, z, (acc, te, ze) = tm.run_steps(
        tm.get_kernel(rc.method), statics, consts, steps
    )
    want = rm.run_serial(rk, rp, rn, rcfg, ITERS)
    for got, ref in ((acc[0], want.accuracy), (te[0], want.test_error),
                     (ze[0], want.z_err), (x[0], want.final_x),
                     (z[0], want.final_z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_reference_batch_through_port_step():
    """repro's stacked batch of each family (sI + csI mixed; every other
    method alone), 2 seeds each, through the port's step == repro's
    run_batch, run by run."""
    for family in BATCH_FAMILIES:
        pairs = [_cases(m, s) for m in family for s in (0, 1)]
        mats = [_materialize(rc, "repro") for rc, _ in pairs]
        rk = mats[0][0]
        args = ([m[1] for m in mats], [m[2] for m in mats], [m[3] for m in mats])
        preps, statics, consts, steps = r_driver._stack_batch(rk, *args, ITERS)
        consts, steps = tm.prepared_to_device(consts, steps, **CPU64)
        x, z, (acc, te, ze) = tm.run_steps(
            tm.get_kernel(pairs[0][0].method), statics, consts, steps
        )
        want = rm.run_batch(rk, *args, ITERS)
        for r, tr in enumerate(want):
            np.testing.assert_allclose(acc[r].numpy(), tr.accuracy, **TOL)
            np.testing.assert_allclose(te[r].numpy(), tr.test_error, **TOL)
            np.testing.assert_allclose(ze[r].numpy(), tr.z_err, **TOL)
            np.testing.assert_allclose(x[r].numpy(), tr.final_x, **TOL)
            np.testing.assert_allclose(z[r].numpy(), tr.final_z, **TOL)


@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_port_run_serial_matches_reference(method):
    rc, tc = _cases(method, seed=2)
    rk, rp, rn, rcfg = _materialize(rc, "repro")
    tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
    _assert_traces_close(
        tm.run_serial(tk, tp, tn, tcfg, ITERS, **CPU64),
        rm.run_serial(rk, rp, rn, rcfg, ITERS),
    )


def test_port_serial_equals_port_batch():
    """The serial driver is the R = 1 case of the batched one: row by row
    the same traces, for every family (the batch's MU is the max over its
    runs, so rows past a run's own mu add exact zeros in another summation
    length)."""
    for family in BATCH_FAMILIES:
        pairs = [_cases(m, s) for m in family for s in (0, 1)]
        mats = [_materialize(tc, "repro_torch") for _, tc in pairs]
        tk = mats[0][0]
        batch = tm.run_batch(
            tk, [m[1] for m in mats], [m[2] for m in mats],
            [m[3] for m in mats], ITERS, **CPU64,
        )
        for (k, p, n, c), tb in zip(mats, batch):
            _assert_traces_close(tm.run_serial(k, p, n, c, ITERS, **CPU64), tb)


def test_mixed_S_batch_gathers_out_of_bounds_and_matches():
    """A mixed-S batch shares the gather bound MU = max mu, so the S=2 run
    indexes past its N*b pool on the last agent's last partition (JAX
    clamps such a gather; torch would raise). The port clamps explicitly,
    and the rows past mu carry weight 0: it must run and match repro."""
    iters = 80
    pairs = [
        _cases("csI-ADMM", seed=0, S=0, scheme="uncoded", iters=iters),
        _cases("csI-ADMM", seed=0, S=2, scheme="cyclic", iters=iters),
    ]
    tmats = [_materialize(tc, "repro_torch") for _, tc in pairs]
    tk = tmats[0][0]
    preps, statics = t_driver._stack_batch(
        tk, [m[1] for m in tmats], [m[2] for m in tmats],
        [m[3] for m in tmats], iters,
    )
    prob = tmats[1][1]
    agents, offsets = preps[1].steps[0], preps[1].steps[1]
    unclamped = (
        agents * prob.b + (statics["K"] - 1) * statics["P"] + offsets
        + statics["MU"] - 1
    )
    assert unclamped.max() > prob.N * prob.b - 1  # the fault is exercised
    got = tm.run_batch(
        tk, [m[1] for m in tmats], [m[2] for m in tmats],
        [m[3] for m in tmats], iters, **CPU64,
    )
    rmats = [_materialize(rc, "repro") for rc, _ in pairs]
    want = rm.run_batch(
        rmats[0][0], [m[1] for m in rmats], [m[2] for m in rmats],
        [m[3] for m in rmats], iters,
    )
    for g, w in zip(got, want):
        _assert_traces_close(g, w)


def test_run_incremental_admm_wrapper():
    rc, tc = _cases("csI-ADMM", seed=1)
    _, rp, rn, _ = _materialize(rc, "repro")
    _, tp, tn, _ = _materialize(tc, "repro_torch")
    _assert_traces_close(
        t_run_incremental(tp, tn, tc.admm_config(), ITERS,
                          straggler=tc.timing_model(), **CPU64),
        r_run_incremental(rp, rn, rc.admm_config(), ITERS,
                          straggler=rc.timing_model()),
    )


def test_float32_run_tracks_float64():
    """The default run dtype (float32) on the CPU stays within f32
    round-off of the f64 run (normwise 1e-4; measured below 1e-5)."""
    _, tc = _cases("csI-ADMM", seed=0)
    tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
    a = tm.run_serial(tk, tp, tn, tcfg, ITERS, device="cpu")
    b = tm.run_serial(tk, tp, tn, tcfg, ITERS, **CPU64)
    assert a.final_x.dtype == np.float32
    for f in FIELDS:
        x, y = getattr(a, f).astype(np.float64), getattr(b, f)
        assert np.abs(x - y).max() <= 1e-4 * np.abs(y).max(), f


ASYNC_TIMINGS = (dict(tau_max=2e-3), dict(churn_rate=20.0, mttr=0.05))


@pytest.mark.parametrize("method,timing", [
    pytest.param(m, t, id=f"timing{j}" if m == "csI-ADMM" else f"{m}-timing{j}")
    for m in ("csI-ADMM", "D-ADMM", "DGD", "EXTRA", "pI-ADMM", "cq-sI-ADMM")
    for j, t in enumerate(ASYNC_TIMINGS)
])
def test_async_matches_reference(method, timing):
    """Async mode (the ADMM pend ring, the gossip history rings): the
    port's host side — signature, statics, slots, activity, clock — is
    the reference's bit for bit, and its traces are within rtol 1e-9."""
    rc, tc = _cases(method)
    rk, rp, rn, rcfg = _materialize(rc, "repro")
    tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
    rrun = dataclasses.replace(rcfg, timing=type(rcfg.timing)(**timing))
    trun = dataclasses.replace(tcfg, timing=TimingModel(**timing))
    sig = tk.static_signature(tp, trun, ITERS)
    assert sig == rk.static_signature(rp, rrun, ITERS)
    assert ("async", trun.timing.staleness_cap) in zip(sig, sig[1:])
    a, b = rk.prepare(rp, rn, rrun, ITERS), tk.prepare(tp, tn, trun, ITERS)
    assert a.statics == b.statics and b.statics["ASYNC"]
    for x, y in zip(a.steps, b.steps, strict=True):
        assert np.asarray(x).dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(a.sim_time, b.sim_time)
    _assert_traces_close(
        tm.run_serial(tk, tp, tn, trun, ITERS, **CPU64),
        rm.run_serial(rk, rp, rn, rrun, ITERS),
    )


@pytest.mark.parametrize("timing", ASYNC_TIMINGS)
def test_walkman_async_raises_the_reference_error(timing):
    """W-ADMM has no event-driven mode at all: the port raises the
    reference's own error, message included."""
    msgs = []
    for pkg, case in zip(("repro", "repro_torch"), _cases("W-ADMM")):
        k, p, n, cfg = _materialize(case, pkg)
        timing_cls = type(cfg.timing)
        run = dataclasses.replace(cfg, timing=timing_cls(**timing))
        with pytest.raises(NotImplementedError) as err:
            k.prepare(p, n, run, ITERS)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "no event-driven mode" in msgs[1]


def test_unported_paths_raise():
    _, tc = _cases("sI-ADMM")
    tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
    with pytest.raises(ValueError, match="run dtype"):
        tm.run_serial(tk, tp, tn, tcfg, ITERS, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="run dtype"):
        tm.run_sharded(tk, [tp], [tn], [tcfg], ITERS, devices=["cpu"],
                       dtype=torch.bfloat16)
    exact = dataclasses.replace(
        tcfg, cfg=dataclasses.replace(tcfg.cfg, exact_x=True)
    )
    with pytest.raises(ValueError, match="static signatures"):
        tm.run_batch(tk, [tp, tp], [tn, tn], [tcfg, exact], ITERS, **CPU64)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    _, tc = _cases("sI-ADMM")
    tk, tp, tn, tcfg = _materialize(tc, "repro_torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.run_serial(tk, tp, tn, tcfg, ITERS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.prepared_to_device((np.zeros(2),), (), device="cuda", dtype=torch.float32)
