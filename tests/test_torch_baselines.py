"""The port's §V-A baselines through their serial entry points
(`repro_torch.core.baselines`) against `repro.core.baselines`.

Same problem and network in both packages (host side bitwise equal); the
device side runs on the CPU in float64 and must track the reference at
rtol 1e-9 / atol 1e-12, with the clock and communication counts equal.
"""

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc

ITERS = 60
TOL = dict(rtol=1e-9, atol=1e-12)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _both(pkg):
    ds = pkg.problems._planted(3000, 300, 5, 2, 0.05, seed=3, name="small")
    return pkg.allocate(ds, N=6, K=3), pkg.make_network(6, connectivity=0.6, seed=1)


@pytest.fixture(scope="module")
def setups():
    return _both(rc), _both(tc)


@pytest.mark.parametrize("entry,args", [
    ("run_wadmm", lambda pkg: (pkg.ADMMConfig(rho=1.0, c_tau=0.5, c_gamma=2.0, M=30),)),
    ("run_dadmm", lambda pkg: (0.5,)),
    ("run_dgd", lambda pkg: (0.5,)),
    ("run_extra", lambda pkg: (0.3,)),
])
def test_entry_point_matches_reference(setups, entry, args):
    (rp, rn), (tp, tn) = setups
    want = getattr(rc, entry)(rp, rn, *args(rc), ITERS)
    got = getattr(tc, entry)(tp, tn, *args(tc), ITERS, **CPU64)
    for f in ("accuracy", "test_error", "z_err", "final_x", "final_z"):
        np.testing.assert_allclose(
            getattr(got, f), np.asarray(getattr(want, f)), err_msg=f, **TOL
        )
    assert np.array_equal(got.comm_cost, want.comm_cost)
    assert np.array_equal(got.sim_time, want.sim_time)


def test_dgd_constant_step_matches_reference(setups):
    (rp, rn), (tp, tn) = setups
    want = rc.run_dgd(rp, rn, 0.2, ITERS, diminishing=False)
    got = tc.run_dgd(tp, tn, 0.2, ITERS, diminishing=False, **CPU64)
    np.testing.assert_allclose(got.accuracy, want.accuracy, **TOL)


def test_entry_points_default_to_the_card(setups):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    _, (tp, tn) = setups
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_dgd(tp, tn, 0.5, 5)
