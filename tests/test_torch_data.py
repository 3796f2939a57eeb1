"""`repro_torch.data.lsq` is the reference's `repro.data.lsq` bit for bit."""

import numpy as np
import pytest

import repro.core as rc
import repro.data as rd
import repro_torch.core as tc
import repro_torch.data as td


@pytest.mark.parametrize("scheme,K,S,b", [
    ("uncoded", 3, 0, 100), ("cyclic", 6, 2, 361), ("fractional", 4, 1, 97),
    ("mds", 5, 2, 50),
])
def test_partition_for_code_is_the_reference(scheme, K, S, b):
    rb, rs = rd.partition_for_code(b, rc.make_code(scheme, K, S, seed=1))
    tb, ts = td.partition_for_code(b, tc.make_code(scheme, K, S, seed=1))
    assert rb.dtype == tb.dtype and np.array_equal(rb, tb)
    assert len(rs) == len(ts) == K
    for x, y in zip(rs, ts):
        assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y)


def test_partition_for_code_rejects_too_few_rows():
    with pytest.raises(ValueError, match="too small"):
        td.partition_for_code(2, tc.make_code("uncoded", 3, 0))


@pytest.mark.parametrize("P,mu", [(12, 4), (12, 5), (3, 7), (60, 20)])
def test_ecn_batch_indices_is_the_reference(P, mu):
    cycle = np.arange(25)
    want = rd.ecn_batch_indices(cycle, P, mu)
    got = td.ecn_batch_indices(cycle, P, mu)
    assert got.dtype == want.dtype and np.array_equal(got, want)
