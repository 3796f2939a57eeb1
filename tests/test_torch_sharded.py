"""The port's sharded tier (`run_sharded`) against `run_batch` and `repro`.

Here the devices are the CPU listed several times (``["cpu"] * 3``); on
a machine with cards the default list is every visible CUDA device. The
runs axis is padded to a multiple of D by repeating the last run, chunked
under ``REPRO_SHARD_MEM_MB`` and split into D shards that step in
lockstep. On the Trace path the result must equal `run_batch` bit for
bit (no operation crosses the runs axis); with a `Reduction`, the lazy
per-chunk path must equal `run_batch`'s summaries and the reference's
sharded run at 1e-12.

The bitwise checks use shards of at least two runs. On the CPU, torch
sends a batched product of ONE matrix with a vector (the test set's
cross term, d = 1) to another routine than a larger batch — another
summation order — so a one-run shard differs from `run_batch` in the
last bits for a reason outside the tier; `test_one_run_shards` holds
that case at 1e-12.
"""

import numpy as np
import pytest
import torch

import repro.methods as rm
import repro_torch.methods as tm
from repro.core.admm import ADMMConfig as RConfig
from repro.methods import driver as r_driver
from repro.methods.admm import ADMMRun as RRun
from repro_torch.core.admm import ADMMConfig as TConfig
from repro_torch.experiments import sweep as t_sweep
from repro_torch.methods import driver as t_driver
from repro_torch.methods.admm import ADMMRun as TRun
from test_torch_reductions import FULL, assert_summaries_close

CPU64 = dict(dtype=torch.float64)
ITERS = 30
CPUS = ["cpu"] * 3
FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z",
          "comm_cost", "sim_time")


def _runs(pkg, n):
    """n csI-ADMM runs of mixed S (so mixed mu under one bound MU)."""
    from importlib import import_module

    core = import_module(f"{pkg}.core")
    cfg_cls, run_cls = (RConfig, RRun) if pkg == "repro" else (TConfig, TRun)
    probs, nets, cfgs = [], [], []
    for s in range(n):
        S = (1, 2, 0)[s % 3]
        nets.append(core.make_network(5, 0.5, seed=s))
        probs.append(core.allocate(core.DATASETS["usps"](s), 5, 6))
        cfgs.append(run_cls(cfg_cls(
            M=36, K=6, S=S, scheme="cyclic" if S else "uncoded", seed=s,
        )))
    return probs, nets, cfgs


def _same_traces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            assert np.array_equal(getattr(g, f), getattr(w, f)), f


@pytest.mark.parametrize("R", [6, 5, 7])
def test_sharded_trace_path_equals_batch_bitwise(R):
    """R = 5 and 7 pad the runs axis (not multiples of D = 3)."""
    kernel = tm.get_kernel("csI-ADMM")
    probs, nets, cfgs = _runs("repro_torch", R)
    batch = tm.run_batch(kernel, probs, nets, cfgs, ITERS, device="cpu", **CPU64)
    sharded = tm.run_sharded(kernel, probs, nets, cfgs, ITERS, devices=CPUS,
                             **CPU64)
    _same_traces(sharded, batch)


def test_one_run_shards():
    kernel = tm.get_kernel("csI-ADMM")
    probs, nets, cfgs = _runs("repro_torch", 3)
    batch = tm.run_batch(kernel, probs, nets, cfgs, ITERS, device="cpu", **CPU64)
    sharded = tm.run_sharded(kernel, probs, nets, cfgs, ITERS, devices=CPUS,
                             **CPU64)
    for g, w in zip(sharded, batch):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-12, atol=0, err_msg=f)


def test_sharded_trace_path_matches_reference():
    rp, rn, rc = _runs("repro", 5)
    tp, tn, tc = _runs("repro_torch", 5)
    want = rm.run_sharded(rm.get_kernel("csI-ADMM"), rp, rn, rc, ITERS)
    got = tm.run_sharded(tm.get_kernel("csI-ADMM"), tp, tn, tc, ITERS,
                         devices=CPUS, **CPU64)
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(g, f), np.asarray(getattr(w, f)),
                                       rtol=1e-9, atol=1e-12, err_msg=f)


def test_chunked_execution_matches_unchunked(monkeypatch):
    """Chunks of 6 runs (two per device) over 16 runs: 6 + 6 + 4, the
    last padded to 6; the chunk boundaries are invisible in the outputs.
    (A zero budget's chunks of D runs are the lazy path's test below.)"""
    kernel = tm.get_kernel("csI-ADMM")
    probs, nets, cfgs = _runs("repro_torch", 16)
    whole = tm.run_sharded(kernel, probs, nets, cfgs, ITERS, devices=CPUS,
                           **CPU64)
    monkeypatch.setattr(t_driver, "_chunk_runs", lambda R_pad, D, per: 2 * D)
    calls = []
    run_chunk = t_driver._run_chunk
    monkeypatch.setattr(t_driver, "_run_chunk",
                        lambda *a: calls.append(a[2][0].shape[0]) or run_chunk(*a))
    chunked = tm.run_sharded(kernel, probs, nets, cfgs, ITERS, devices=CPUS,
                             **CPU64)
    assert calls == [6, 6, 4]
    _same_traces(chunked, whole)


def test_chunk_rule_device_aligned(monkeypatch):
    """Chunk sizes are multiples of D, at least D, at most the padded R —
    the reference's rule, value for value."""
    cases = [(16, 8, 10 * 2**20), (24, 4, 1), (9, 3, 5 * 2**20), (6, 3, 2**30)]
    for budget in ("0", "1", "64", "4096"):
        monkeypatch.setenv("REPRO_SHARD_MEM_MB", budget)
        for R_pad, D, per in cases:
            got = t_driver._chunk_runs(R_pad, D, per)
            assert got == r_driver._chunk_runs(R_pad, D, per)
            assert got % D == 0 and D <= got <= R_pad
    monkeypatch.setenv("REPRO_SHARD_MEM_MB", "1")
    assert t_driver._chunk_runs(16, 8, per_run_bytes=10 * 2**20) == 8
    monkeypatch.setenv("REPRO_SHARD_MEM_MB", "4096")
    assert t_driver._chunk_runs(16, 8, per_run_bytes=10 * 2**20) == 16
    assert t_driver._chunk_runs(24, 4, per_run_bytes=1) == 24


@pytest.mark.parametrize("budget", [None, "0"])
def test_lazy_reduced_path_matches_batch_and_reference(monkeypatch, budget):
    """The streaming sharded path prepares each chunk lazily; its
    summaries equal the port's run_batch and the reference's sharded
    run of the same runs."""
    if budget is not None:
        monkeypatch.setenv("REPRO_SHARD_MEM_MB", budget)
    r_spec, t_spec = rm.Reduction(**FULL), tm.Reduction(**FULL)
    rp, rn, rc = _runs("repro", 5)
    tp, tn, tc = _runs("repro_torch", 5)
    kernel = tm.get_kernel("csI-ADMM")
    prepared = []
    prepare = type(kernel).prepare
    monkeypatch.setattr(type(kernel), "prepare",
                        lambda self, *a: prepared.append(1) or prepare(self, *a))
    got = tm.run_sharded(kernel, tp, tn, tc, ITERS, t_spec, devices=CPUS,
                         **CPU64)
    assert len(prepared) == 1 + 5  # one probe, then every run once
    want = rm.run_sharded(rm.get_kernel("csI-ADMM"), rp, rn, rc, ITERS,
                          reductions=r_spec)
    assert_summaries_close(got, want, label="reference")
    batch = tm.run_batch(kernel, tp, tn, tc, ITERS, t_spec, device="cpu",
                         **CPU64)
    assert_summaries_close(got, batch, label="run_batch")


def test_lazy_path_checks_the_statics_bound(monkeypatch):
    kernel = tm.get_kernel("csI-ADMM")
    probs, nets, cfgs = _runs("repro_torch", 4)
    spec = tm.Reduction()
    monkeypatch.setattr(type(kernel), "max_statics_bound",
                        lambda self, p, c, i: dict(MU=1))
    with pytest.raises(ValueError, match="under-bounds MU"):
        tm.run_sharded(kernel, probs, nets, cfgs, ITERS, spec, devices=CPUS,
                       **CPU64)
    monkeypatch.setattr(type(kernel), "max_statics_bound",
                        lambda self, p, c, i: {})
    with pytest.raises(ValueError, match="implement the bound hook"):
        tm.run_sharded(kernel, probs, nets, cfgs, ITERS, spec, devices=CPUS,
                       **CPU64)


def test_single_device_and_single_run_fall_back_to_batch(monkeypatch):
    kernel = tm.get_kernel("csI-ADMM")
    probs, nets, cfgs = _runs("repro_torch", 3)
    batch = tm.run_batch(kernel, probs, nets, cfgs, ITERS, device="cpu", **CPU64)
    calls = []
    run_batch = t_driver.run_batch
    monkeypatch.setattr(t_driver, "run_batch",
                        lambda *a, **k: calls.append(k["device"]) or run_batch(*a, **k))
    one = tm.run_sharded(kernel, probs, nets, cfgs, ITERS, devices=["cpu"],
                         **CPU64)
    _same_traces(one, batch)
    single = tm.run_sharded(kernel, probs[:1], nets[:1], cfgs[:1], ITERS,
                            devices=CPUS, **CPU64)
    assert calls == [torch.device("cpu")] * 2
    _same_traces(single, run_batch(kernel, probs[:1], nets[:1], cfgs[:1],
                                   ITERS, device="cpu", **CPU64))


def test_sweep_modes_and_device_lists(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert t_sweep._resolve_mode("auto", cpu) == "batched"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 2)
        m.setattr(torch.cuda, "is_available", lambda: True)
        assert t_sweep._resolve_mode("auto", cuda) == "sharded"
        assert t_sweep._resolve_mode("auto", cpu) == "batched"
        assert t_sweep._shard_devices(None, cuda) == [
            torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert t_sweep._resolve_mode("auto", cuda) == "batched"
    assert t_sweep._resolve_mode("sharded", cpu) == "sharded"
    assert t_sweep._shard_devices(None, cpu) == [cpu]
    assert t_sweep._shard_devices(CPUS, cuda) == [cpu] * 3
    if not torch.cuda.is_available():
        kernel = tm.get_kernel("csI-ADMM")
        probs, nets, cfgs = _runs("repro_torch", 2)
        with pytest.raises(RuntimeError, match="devices="):
            tm.run_sharded(kernel, probs, nets, cfgs, ITERS)
