"""The port's bandit controller (a-csI-ADMM) against `repro.control`.

Host side — the arm tables, the reward surface, the numpy ``replay`` —
is the reference's bit for bit. Device side: UCB1/EXP3 ``select`` and
``update`` over a runs axis equal the reference's per-run functions on
planted states (ties included: the first of equal values wins), the
device pull sequence equals ``replay`` exactly, a single-arm controller
is the static csI-ADMM run bit for bit, and adaptive sweeps (with a
`Reduction`, and under async churn) equal the reference's per case.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.control as rc
import repro.experiments as rx
import repro_torch.control as tc
import repro_torch.experiments as tx
from test_torch_reductions import assert_summaries_close

CPU64 = dict(device="cpu", dtype=torch.float64)
ITERS = 30
TOL = dict(rtol=1e-9, atol=1e-12)
FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z")
# A feasible 3-cell slice of the code_frontier grid (K=6).
ARMS = (("cyclic", 1, None), ("cyclic", 2, None), ("approx", 2, 3e-4))


def _case(mod, **kw):
    kw = {**dict(method="a-csI-ADMM", dataset="synthetic", K=6, M=360,
                 iters=ITERS, p_straggle=0.3, delay=5e-3, arms=ARMS), **kw}
    return mod.Case(**kw)


def _materialize(case, pkg):
    from importlib import import_module

    core = import_module(f"{pkg}.core")
    net = core.make_network(case.N, case.connectivity, seed=case.seed)
    prob = core.allocate(core.DATASETS[case.dataset](case.seed), case.N, case.K)
    return prob, net


def _planted_states(A=4):
    """Planted (n, s) carries: round-robin, exact index ties, spread."""
    n = np.array([[0, 0, 0, 0], [1, 1, 0, 0], [3, 3, 2, 2], [5, 1, 7, 2],
                  [2, 2, 2, 2], [4, 4, 4, 4]], dtype=float)[:, :A]
    s = np.array([[0, 0, 0, 0], [0.5, 0.2, 0, 0], [1.5, 1.5, 1.0, 1.0],
                  [2.0, 0.9, 3.1, 1.2], [1.0, 1.0, 1.0, 1.0],
                  [-0.3, 2.0, 0.7, 2.0]])[:, :A]
    return n, s


@pytest.mark.parametrize("algo", tc.BANDIT_ALGOS)
def test_select_and_update_match_reference_on_planted_states(algo):
    n, s = _planted_states()
    A = n.shape[1]
    R = n.shape[0]
    rng = np.random.default_rng(3)
    u, logk = rng.random(R), np.log(np.arange(1, R + 1) + 6.0)
    par = np.array([0.5, 0.2, 0.1])
    reward = rng.random((R, A))
    state = dict(n=torch.from_numpy(n), s=torch.from_numpy(s))
    tpar = torch.from_numpy(np.tile(par, (R, 1)))
    arm = tc.select(algo, state, torch.from_numpy(u), torch.from_numpy(logk),
                    tpar, A)
    new = tc.update(algo, state, arm,
                    torch.from_numpy(reward)[torch.arange(R), arm], tpar, A)
    for r in range(R):
        st = dict(n=jnp.asarray(n[r]), s=jnp.asarray(s[r]))
        want = int(rc.select(algo, st, u[r], logk[r], jnp.asarray(par), A))
        assert int(arm[r]) == want, (algo, r)
        upd = rc.update(algo, st, want, reward[r, want], jnp.asarray(par), A)
        np.testing.assert_array_equal(new["n"][r].numpy(), np.asarray(upd["n"]))
        np.testing.assert_allclose(new["s"][r].numpy(), np.asarray(upd["s"]),
                                   rtol=1e-15, atol=0)
    if algo == "ucb1":
        # Exact ties go to the first index: rows 4 and 5 (equal indices)
        # and row 0 (round-robin start).
        assert arm.tolist()[0] == 0 and arm.tolist()[4] == 0
        assert arm.tolist()[5] == 1


@pytest.mark.parametrize("algo", tc.BANDIT_ALGOS)
def test_device_pulls_equal_host_replay(algo):
    """The device controller's pulls equal the numpy replay, which is the
    reference's replay, which equals the reference's device pulls."""
    case = {mod: _case(mod, bandit=algo, iters=60) for mod in (rx, tx)}
    tprob, tnet = _materialize(case[tx], "repro_torch")
    rprob, rnet = _materialize(case[rx], "repro")
    trun = tc.ADAPTIVE_KERNEL.config(case[tx])
    rrun = rc.ADAPTIVE_KERNEL.config(case[rx])
    ttab = tc.ADAPTIVE_KERNEL._arm_tables(tprob, tnet, trun, 60)
    rtab = rc.ADAPTIVE_KERNEL._arm_tables(rprob, rnet, rrun, 60)
    for k in ("W", "wmask", "offsets", "act", "mu_arms", "dt_arm", "rewards",
              "u", "logk", "pulls", "sim_time"):
        assert np.array_equal(ttab[k], rtab[k]), k
    dev = tc.device_pulls(tprob, tnet, trun, 60, device="cpu")
    assert dev.dtype == np.int32
    np.testing.assert_array_equal(dev, ttab["pulls"])
    np.testing.assert_array_equal(dev, rc.device_pulls(rprob, rnet, rrun, 60))
    if algo == "ucb1":
        assert list(dev[: len(ARMS)]) == list(range(len(ARMS)))
    with pytest.raises(ValueError, match="multi-arm"):
        tc.device_pulls(tprob, tnet, dataclasses.replace(trun, arms=ARMS[:1]),
                        60, device="cpu")


def test_single_arm_equals_static_path_bitwise():
    """A one-arm controller is the fixed-cell csI-ADMM run: same statics,
    steps and bits, but its own group (the adaptive suffix)."""
    for scheme, S, deadline in ARMS:
        adaptive = _case(tx, arms=((scheme, S, deadline),), seed=1)
        static = dataclasses.replace(
            adaptive, method="csI-ADMM", scheme=scheme, S=S, deadline=deadline,
            arms=(),
        )
        res = tx.run_sweep([adaptive, static], **CPU64)
        assert res.n_dispatches == 2
        assert res.groups[0][0][-3:] == ("adaptive", 1, "ucb1")
        a, b = res.traces
        for f in FIELDS + ("sim_time", "comm_cost"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (scheme, f)


def test_adaptive_sweep_serial_batched_and_reference():
    cases = {mod: [_case(mod, bandit=a, seed=s)
                   for a in ("ucb1", "exp3") for s in range(2)]
             for mod in (rx, tx)}
    serial = tx.run_sweep(cases[tx], mode="serial", **CPU64)
    batched = tx.run_sweep(cases[tx], mode="batched", **CPU64)
    ref = rx.run_sweep(cases[rx], mode="batched")
    assert batched.groups == ref.groups and batched.n_dispatches == 2
    for s, b, r in zip(serial.traces, batched.traces, ref.traces):
        assert np.array_equal(b.sim_time, r.sim_time)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(b, f), getattr(s, f), **TOL)
            np.testing.assert_allclose(getattr(b, f), np.asarray(getattr(r, f)),
                                       err_msg=f, **TOL)


def test_adaptive_composes_with_streaming_reductions():
    def spec(mod):
        return dataclasses.replace(
            mod.get_sweep("adaptive_frontier", iters=24, runs=1),
            reductions=mod.Reduction(fields=("accuracy",), budgets=(0.5, 1.0),
                                     x="sim_time", quantiles=(0.5,)),
        )

    res = tx.run_sweep(spec(tx), **CPU64)
    ref = rx.run_sweep(spec(rx), mode="batched")
    assert res.traces == [] and res.groups == ref.groups
    for v in res.reduced.values():
        assert np.isfinite(v).all()
    assert_summaries_close(res.reduced, ref.reduced)


def test_adaptive_async_churn_no_nan_leak():
    """Bounded staleness + agent churn under the controller: dead-agent
    arm pulls stay finite, and the run equals the reference's."""
    kw = dict(tau_max=2e-3, churn_rate=2.0, mttr=5e-3)
    got = tx.run_sweep([_case(tx, **kw)], **CPU64)
    want = rx.run_sweep([_case(rx, **kw)], mode="batched")
    assert got.groups == want.groups
    sig = got.groups[0][0]
    assert ("async", 8) in zip(sig, sig[1:]) and sig[-3] == "adaptive"
    g, w = got.traces[0], want.traces[0]
    assert np.isfinite(g.accuracy).all() and np.isfinite(g.final_z).all()
    assert np.array_equal(g.sim_time, w.sim_time)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(g, f), np.asarray(getattr(w, f)),
                                   err_msg=f, **TOL)


def test_config_errors_match_reference():
    bad = (dict(arms=()), dict(arms=(("approx", 0, None),)),
           dict(arms=(("cyclic", 1, None), ("cyclic", 1, None))),
           dict(bandit="greedy"))
    for kw in bad:
        msgs = []
        for mod, pkg in ((rc, rx), (tc, tx)):
            with pytest.raises(ValueError) as err:
                mod.ADAPTIVE_KERNEL.config(_case(pkg, **kw))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], kw

    class _ExactCase:
        def __init__(self, case):
            self._case = case

        def __getattr__(self, name):
            return getattr(self._case, name)

        def admm_config(self):
            return dataclasses.replace(self._case.admm_config(), exact_x=True)

    with pytest.raises(ValueError, match="stochastic coded"):
        tc.ADAPTIVE_KERNEL.config(_ExactCase(_case(tx)))
    for kw in (dict(c=-1.0), dict(gamma=0.0), dict(algo="greedy")):
        with pytest.raises(ValueError):
            tc.BanditPolicy(**kw)
    assert np.array_equal(tc.BanditPolicy().params, rc.BanditPolicy().params)
    for a, b in zip(tc.schedule_inputs(50, 3), rc.schedule_inputs(50, 3)):
        assert np.array_equal(a, b)


def test_max_statics_bound_matches_prepare_and_reference():
    case = {mod: _case(mod) for mod in (rx, tx)}
    tprob, tnet = _materialize(case[tx], "repro_torch")
    rprob, rnet = _materialize(case[rx], "repro")
    for arms in (ARMS, ARMS[1:2]):
        trun = dataclasses.replace(tc.ADAPTIVE_KERNEL.config(case[tx]), arms=arms)
        rrun = dataclasses.replace(rc.ADAPTIVE_KERNEL.config(case[rx]), arms=arms)
        bound = tc.ADAPTIVE_KERNEL.max_statics_bound(tprob, trun, ITERS)
        assert bound == rc.ADAPTIVE_KERNEL.max_statics_bound(rprob, rrun, ITERS)
        assert bound == tc.ADAPTIVE_KERNEL.prepare(
            tprob, tnet, trun, ITERS).max_statics
