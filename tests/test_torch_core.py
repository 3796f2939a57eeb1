"""Host-side parity of the PyTorch port's `core` against `repro.core`.

The port keeps its own numpy copies of graph, problems, coding, timing
and the schedule sampler, so every array here must be BITWISE equal to
the reference's on the same seeds (``np.array_equal``, no tolerance), and
every error message word for word.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.admm as r_admm
import repro.core.coding as r_coding
import repro.core.graph as r_graph
import repro.core.problems as r_problems
import repro.core.timing as r_timing
import repro_torch.core.admm as t_admm
import repro_torch.core.coding as t_coding
import repro_torch.core.graph as t_graph
import repro_torch.core.problems as t_problems
import repro_torch.core.timing as t_timing

SEEDS = (0, 1, 2)
KS_GRID = [(3, 0), (3, 1), (4, 1), (4, 2), (6, 1), (6, 2), (6, 3), (8, 3)]


def _assert_same_fields(a, b):
    """Dataclass instances of the two packages carry equal fields."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("N,eta", [(3, 0.5), (5, 0.3), (10, 0.5), (12, 1.0)])
@pytest.mark.parametrize("seed", SEEDS)
def test_graph_bitwise(N, eta, seed):
    a = r_graph.make_network(N, eta, seed=seed)
    b = t_graph.make_network(N, eta, seed=seed)
    _assert_same_fields(a, b)
    assert np.array_equal(a.adjacency, b.adjacency)
    assert np.array_equal(a.degree(), b.degree())
    assert np.array_equal(
        r_graph.metropolis_weights(a), t_graph.metropolis_weights(b)
    )


def test_graph_rejects_tiny_network_alike():
    for mod in (r_graph, t_graph):
        with pytest.raises(ValueError, match="need N >= 3 agents"):
            mod.make_network(2)


@pytest.mark.parametrize("name", sorted(r_problems.DATASETS))
def test_problems_bitwise(name):
    for seed in (0, 3):
        a = r_problems.DATASETS[name](seed)
        b = t_problems.DATASETS[name](seed)
        _assert_same_fields(a, b)
        for N, K in [(10, 3), (10, 6), (5, 4)]:
            pa = r_problems.allocate(a, N, K)
            pb = t_problems.allocate(b, N, K)
            _assert_same_fields(pa, pb)
            assert np.array_equal(pa.x_star(), pb.x_star())
            xs = np.random.default_rng(seed).standard_normal(
                (N, pa.p, pa.d)
            )
            assert pa.global_loss(xs) == pb.global_loss(xs)
            assert pa.test_error(xs[0]) == pb.test_error(xs[0])
            assert pa.accuracy(xs, pa.x_star(), 0 * xs) == pb.accuracy(
                xs, pb.x_star(), 0 * xs
            )
            rows = np.arange(0, pa.b, 3)
            assert np.array_equal(pa.grad(1, xs[1], rows), pb.grad(1, xs[1], rows))
    with pytest.raises(ValueError) as ea:
        r_problems.allocate(r_problems.make_usps_standin(), 2000, 1)
    with pytest.raises(ValueError) as eb:
        t_problems.allocate(t_problems.make_usps_standin(), 2000, 1)
    assert str(ea.value) == str(eb.value)


def _alive_patterns(K):
    rng = np.random.default_rng(K)
    return [rng.random(K) > 0.3 for _ in range(6)] + [np.ones(K, bool)]


@pytest.mark.parametrize("family", sorted(r_coding.CODE_FAMILIES))
def test_coding_bitwise_every_family(family):
    assert sorted(t_coding.CODE_FAMILIES) == sorted(r_coding.CODE_FAMILIES)
    rf, tf = r_coding.CODE_FAMILIES[family], t_coding.CODE_FAMILIES[family]
    assert (rf.exact, rf.replication) == (tf.exact, tf.replication)
    for K, S in KS_GRID:
        for seed in (0, 1):
            try:
                a = r_coding.make_code(family, K, S, seed=seed)
            except ValueError as exc:
                # Infeasible: the port raises the same words.
                with pytest.raises(ValueError) as eb:
                    t_coding.make_code(family, K, S, seed=seed)
                assert str(eb.value) == str(exc)
                continue
            b = t_coding.make_code(family, K, S, seed=seed)
            _assert_same_fields(a, b)
            assert b.verify()
            assert a.replication == b.replication
            for alive in _alive_patterns(K):
                try:
                    va = a.decode_vector(alive)
                except ValueError as exc:
                    with pytest.raises(ValueError) as eb:
                        b.decode_vector(alive)
                    assert str(eb.value) == str(exc)
                    continue
                assert np.array_equal(va, b.decode_vector(alive))
    _assert_same_fields(r_coding.paper_fig2_code(), t_coding.paper_fig2_code())


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.make_code("fractional", 5, 1),
        lambda m: m.make_code("fractional", 9, 1),
        lambda m: m.make_code("cyclic", 3, 5),
        lambda m: m.make_code("cyclic", 4, -1),
        lambda m: m.make_code("mds", 4, 4),
        lambda m: m.make_code("approx", 6, 0),
        lambda m: m.make_code("uncoded", 4, 1),
        lambda m: m.make_code("nope", 4, 1),
        lambda m: m.cyclic_repetition_code(3, 5),
        lambda m: m.mds_code(4, 4),
        lambda m: m.make_arm_set(
            (("cyclic", 1, None), ("approx", 0, 3e-4)), K=6
        ),
        lambda m: m.check_arm_set((("cyclic", 1, None), ("fractional", 1, None)), K=5),
        lambda m: m.check_arm_set((), K=6),
        lambda m: m.check_arm_set((("cyclic", 1, None), ("cyclic", 1, None)), K=6),
        lambda m: m.check_arm_set((("approx", 1, -1.0),), K=6),
        lambda m: m.check_arm_set((("cyclic", 1),), K=6),
        lambda m: m.check_arm_set((("bogus", 1, None),), K=6),
    ],
)
def test_coding_infeasible_messages_word_for_word(call):
    with pytest.raises(ValueError) as ea:
        call(r_coding)
    with pytest.raises(ValueError) as eb:
        call(t_coding)
    assert str(ea.value) == str(eb.value)


def test_arm_set_builds_identical_codes():
    arms = (("cyclic", 1, None), ("approx", 2, 1e-3), ("mds", 1, None))
    for a, b in zip(
        r_coding.make_arm_set(arms, K=6), t_coding.make_arm_set(arms, K=6)
    ):
        _assert_same_fields(a, b)


TIMING_MODELS = [
    dict(),
    dict(p_straggle=0.3, delay=5e-3, epsilon=2e-3),
    dict(response="shifted_exp", speed_classes=(1.0, 2.0, 4.0)),
    dict(response="lognormal"),
    dict(response="pareto", deadline=3e-4),
    dict(tau_max=2e-3, churn_rate=20.0, mttr=0.05),
    dict(churn_rate=80.0, mttr=0.0),
]


@pytest.mark.parametrize("kw", TIMING_MODELS)
def test_timing_draws_bitwise(kw):
    ra, tb = r_timing.TimingModel(**kw), t_timing.TimingModel(**kw)
    assert ra.is_async == tb.is_async and ra.reward_cap == tb.reward_cap
    net = r_graph.make_network(6, 0.5, seed=1)
    for seed in SEEDS:
        ea, la = r_timing.sample_times(ra, 50, 4, seed=seed)
        eb, lb = t_timing.sample_times(tb, 50, 4, seed=seed)
        assert np.array_equal(ea, eb) and np.array_equal(la, lb)
        assert np.array_equal(ra.reward(la + ea[:, 0]), tb.reward(lb + eb[:, 0]))
        clock = np.cumsum(la + ea.max(axis=1))
        for n in (0, 3):
            assert np.array_equal(
                ra.staleness_steps(clock, np.random.default_rng([7, seed]), n),
                tb.staleness_steps(clock, np.random.default_rng([7, seed]), n),
            )
        starts = np.concatenate([[0.0], clock[:-1]])
        assert np.array_equal(
            ra.sample_churn(starts, 5, np.random.default_rng([6, seed])),
            tb.sample_churn(starts, 5, np.random.default_rng([6, seed])),
        )
        assert np.array_equal(
            ra.gossip_round_times(net, 30, np.random.default_rng(seed)),
            tb.gossip_round_times(net, 30, np.random.default_rng(seed)),
        )
        agents = np.arange(30) % net.N
        assert np.array_equal(
            ra.walk_step_times(net, agents, np.random.default_rng(seed)),
            tb.walk_step_times(net, agents, np.random.default_rng(seed)),
        )


def test_timing_validation_messages_alike():
    for kw in (dict(deadline=-1.0), dict(tau_max=-1.0), dict(staleness_cap=1),
               dict(response="weibull"), dict(speed_classes=())):
        with pytest.raises(ValueError) as ea:
            r_timing.TimingModel(**kw)
        with pytest.raises(ValueError) as eb:
            t_timing.TimingModel(**kw)
        assert str(ea.value) == str(eb.value)


SCHEDULES = [
    dict(K=3, S=0, scheme="uncoded", M=60),
    dict(K=3, S=1, scheme="cyclic", M=60),
    dict(K=4, S=1, scheme="fractional", M=48),
    dict(K=6, S=2, scheme="mds", M=360),
    dict(K=6, S=3, scheme="cyclic", M=360, traversal="shortest_path"),
]
SCHEDULE_TIMING = [
    dict(p_straggle=0.3, delay=5e-3),
    dict(p_straggle=0.3, delay=5e-3, epsilon=2e-3),
    dict(churn_rate=25.0, mttr=0.05),
]


@pytest.mark.parametrize("cfg_kw", SCHEDULES)
@pytest.mark.parametrize("timing_kw", SCHEDULE_TIMING)
def test_make_schedule_every_array_bitwise(cfg_kw, timing_kw):
    net = r_graph.make_network(10, 0.5, seed=2)
    for seed in (0, 1):
        ra = r_admm.ADMMConfig(seed=seed, **cfg_kw)
        tb = t_admm.ADMMConfig(seed=seed, **cfg_kw)
        assert ra.M_bar == tb.M_bar
        a = r_admm.make_schedule(
            ra, net, r_coding.make_code(ra.scheme, ra.K, ra.S, seed=seed),
            r_timing.TimingModel(**timing_kw), 200, 120,
        )
        b = t_admm.make_schedule(
            tb, t_graph.make_network(10, 0.5, seed=2),
            t_coding.make_code(tb.scheme, tb.K, tb.S, seed=seed),
            t_timing.TimingModel(**timing_kw), 200, 120,
        )
        assert sorted(a) == sorted(b)
        for key in a:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and np.array_equal(x, y), key


def test_make_schedule_partial_recovery_deadline_bitwise():
    """The deadline-truncated decode path (approx family) samples alike."""
    net = r_graph.make_network(10, 0.5, seed=0)
    kw = dict(K=6, S=2, scheme="approx", M=360)
    tm = dict(p_straggle=0.4, delay=5e-3, deadline=2e-4)
    a = r_admm.make_schedule(
        r_admm.ADMMConfig(**kw), net, r_coding.make_code("approx", 6, 2),
        r_timing.TimingModel(**tm), 150, 120,
    )
    b = t_admm.make_schedule(
        t_admm.ADMMConfig(**kw), net, t_coding.make_code("approx", 6, 2),
        t_timing.TimingModel(**tm), 150, 120,
    )
    for key in a:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key


def test_admm_config_validation_alike():
    for kw in (dict(M=50, K=3, S=1), dict(scheme="uncoded", S=1, M=60)):
        with pytest.raises(ValueError) as ea:
            r_admm.ADMMConfig(**kw).validate()
        with pytest.raises(ValueError) as eb:
            t_admm.ADMMConfig(**kw).validate()
        assert str(ea.value) == str(eb.value)
