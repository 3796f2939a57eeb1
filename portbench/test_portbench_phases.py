"""The phase rules (`portbench.phases`) and the readers built on them,
over hand-built traces: busy time placed by launch time, idle time by the
host's span, syncs counted inside ``*.step`` only, and no reading from a
trace without the program's spans (a program that marks none)."""

from portbench import harness, phases, trace
from portbench.trace import Trace

# One step on the window (0, 100) us: the benchmark's batch span, then the
# program's step span holding forward, backward and Adam.
HOST = [
    ("portbench.batch", 0, 8), ("portbench.train_step", 8, 100),
    ("plain.step", 10, 95), ("plain.forward", 10, 30), ("plain.backward", 30, 60),
    ("plain.adam", 60, 90), ("aten::copy_", 62, 66),
    ("cudaMemcpyAsync", 63, 64), ("cudaStreamSynchronize", 64, 66),
    ("cudaMemcpy", 70, 71), ("cudaStreamSynchronize_ptsz", 80, 81),
    ("cudaStreamSynchronize", 97, 99),  # reading the loss, after the step
    ("cudaLaunchKernel", 40, 41),
]
DEVICE = [("fwd", 12, 28), ("bwd", 40, 50), ("bwd_late", 58, 70), ("adam", 80, 92),
          ("orphan", 93, 94)]


def _trace(host=HOST, device=DEVICE):
    return Trace(n_steps=1, wall_s=1e-4, window=(0.0, 100.0), device=list(device),
                 host=list(host), ranges={}, counts={}, calls={})


def _record(trace):
    return harness.Record(cell=None, setup_s=0.0, window_s=0.0, steps=0, peak_bytes=0,
                          trace=trace)


def test_ops_are_placed_by_launch_time_not_by_when_they_ran():
    groups = {g: phases.intervals(HOST, names) for g, names in
              (("forward", phases.FORWARD), ("backward", phases.BACKWARD),
               ("update", phases.UPDATE))}
    # bwd_late is launched inside plain.backward but runs past its end, into
    # plain.adam's span; orphan has no launch time; a launch in the batch span
    # lies in no phase.
    launch_at = [11, 35, 59, 70, None]
    placed, unplaced = phases.place(DEVICE, launch_at, groups)
    assert [n for n, _, _ in placed["forward"]] == ["fwd"]
    assert [n for n, _, _ in placed["backward"]] == ["bwd", "bwd_late"]
    assert [n for n, _, _ in placed["update"]] == ["adam"]
    assert [n for n, _, _ in unplaced] == ["orphan"]
    _, unplaced = phases.place(DEVICE, [11, 35, 59, 5, 70], groups)
    assert [n for n, _, _ in unplaced] == ["adam"]


def test_idle_counts_only_the_part_of_a_gap_inside_the_span():
    # Device gaps: (0, 12), (28, 40), (50, 58), (70, 80), (92, 93), (94, 100).
    model = phases.intervals(HOST, phases.MODEL)
    assert model == [(10, 60)]
    assert phases.idle_in(DEVICE, model, 0.0, 100.0) == 2 + 12 + 8
    update = phases.intervals(HOST, phases.UPDATE)
    assert phases.idle_in(DEVICE, update, 0.0, 100.0) == 10  # (70, 80) of (60, 90)
    assert phases.overlap_us([(0, 5), (7, 9)], [(4, 8)]) == 2
    t = _trace()
    assert harness.reader("model_idle_ms").read(_record(t)) == 22e-3
    assert harness.reader("update_idle_ms").read(_record(t)) == 10e-3


def test_host_syncs_count_only_blocking_calls_inside_the_step():
    step = phases.intervals(HOST, phases.STEP)
    assert phases.syncs_in(HOST, step) == 3  # not the async copy, not the loss read
    assert [phases.is_sync(n) for n in ("cudaMemcpy", "cudaMemcpyAsync",
                                        "cudaDeviceSynchronize", "cudaLaunchKernel")] == \
        [True, False, True, False]
    assert harness.reader("host_syncs_per_step").read(_record(_trace())) == 3


def test_readers_read_nothing_without_the_programs_spans():
    bare = _trace(host=[r for r in HOST if not r[0].startswith("plain.")])
    for name in ("model_idle_ms", "update_idle_ms", "host_syncs_per_step"):
        assert harness.reader(name).read(_record(bare)) is None
        assert harness.reader(name).read(_record(None)) is None


# Two cards on the window (0, 100) us: card 0 busy (0, 40) and (50, 60),
# card 1 busy (20, 90), with two copies from card 0 to card 1 among them
# and one that runs past the window's end.
TWO = [("k0", 0, 30), ("Memcpy PtoP (Device -> Device)", 25, 40), ("k0b", 50, 60),
       ("k1", 20, 80), ("Memcpy PtoP (Device -> Device)", 80, 90),
       ("Memcpy DtoD (Device -> Device)", 85, 88), ("Memcpy PtoP (Device -> Device)", 95, 110)]
TWO_CARD = [0, 0, 0, 1, 1, 1, 1]


def _two_card_trace():
    return Trace(n_steps=2, wall_s=1e-4, window=(0.0, 100.0), device=list(TWO), host=[],
                 ranges={}, counts={}, calls={}, card=list(TWO_CARD), n_cards=2)


def test_several_cards_read_card_by_card():
    t = _two_card_trace()
    assert [n for n, _, _ in t.on_card(1)] == ["k1", "Memcpy PtoP (Device -> Device)",
                                               "Memcpy DtoD (Device -> Device)",
                                               "Memcpy PtoP (Device -> Device)"]
    # card 0 busy 40 + 10 us, card 1 60 + 10 + 5 us: the mean
    assert t.busy_s() == ((50 + 75) / 2) * 1e-6
    idle = harness.reader("device_idle_share").read(_record(t))
    assert abs(idle - 100 * ((50 / 100 + 25 / 100) / 2)) < 1e-9
    # peer copies: 15 + 10 + 5 (clipped) us over 2 steps, in ms
    assert harness.reader("peer_copy_ms").read(_record(t)) == 30 * 1e-3 / 2
    gaps = t.breakdown()["idle_gaps"]
    assert [round(s * 1e6) for _, s in gaps] == [40, 20, 10, 5] and gaps[0][0].startswith("card 0")
    assert harness.peak_bytes([0, 1], {0: 7, 1: 9}.get) == 9
    assert harness.peak_bytes([]) == 0


def test_one_card_reads_as_it_did_before_cards_were_kept():
    """On one card the trace, the idle share and the breakdown give what
    they gave when every operation was taken as on the one card."""
    device = DEVICE + [("Memcpy HtoD (Pageable -> Device)", 94, 96)]
    bare = _trace(device=device)
    kept = Trace(n_steps=1, wall_s=1e-4, window=(0.0, 100.0), device=list(device),
                 host=list(HOST), ranges={}, counts={}, calls={}, card=[0] * len(device))
    before = sum(e - s for s, e in trace.union(device, 0.0, 100.0)) * 1e-6
    for t in (bare, kept):
        assert t.busy_s() == before
        assert harness.reader("device_idle_share").read(_record(t)) == \
            100.0 * (1.0 - before / t.window_s)
        assert t.breakdown() == bare.breakdown()
        assert harness.reader("peer_copy_ms").read(_record(t)) is None
    assert not any(n.startswith("card") for n, _ in bare.breakdown()["idle_gaps"])
