"""The training steps' phase spans (`repro_torch.tracing`) on the CPU.

- Under a recording ``torch.profiler`` each runtime's step records the
  spans of its phases, as many as the step runs them (per agent, per
  committing agent), each inside its ``*.step`` span on the same thread.
- With no profiler recording a step enters ``record_function`` zero
  times, and its results equal those of the same step traced, bit for bit.
- ``launch.train --trace PATH`` writes steps 1 and 2 as a Chrome trace
  holding the spans.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.data import agent_token_streams, make_lm_batch
from repro_torch.distributed import ConsensusConfig, ConsensusRuntime, PlainRuntime
from repro_torch.launch import train
from repro_torch.models import get_model

ARCH = "mamba2-1.3b"
# Spans a step records, with their counts (A = 2 agents).
SPANS = {
    "plain": {"plain.step": 1, "plain.forward": 1, "plain.backward": 1, "plain.clip": 1,
              "plain.adam": 1},
    "incremental": {"consensus.step": 1, "consensus.row_weights": 1, "consensus.load": 2,
                    "consensus.forward": 2, "consensus.backward": 1, "consensus.update": 1,
                    "consensus.z_update": 1},
    "parallel": {"consensus.step": 1, "consensus.row_weights": 1, "consensus.load": 2,
                 "consensus.forward": 2, "consensus.backward": 2, "consensus.update": 2,
                 "consensus.z_update": 1},
}


def _step(mode):
    """One step of a fresh runtime of the mamba2 smoke model (seed 0):
    () -> (metrics, the tensors the step updated)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), remat="full")
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if mode == "plain":
        rt = PlainRuntime(model)
        state = rt.init_state()
        stream = agent_token_streams(1, cfg.vocab, seed=0)[0]
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(stream, 2, 16).items()}

        def run():
            _, metrics = rt.train_step(state, batch)
            return metrics, [*model.parameters(), *state["opt"]["m"].values(),
                             *state["opt"]["v"].values()]
        return run
    ccfg = ConsensusConfig(n_agents=2, K=4, S=1, c_tau=20.0, c_gamma=0.1, mode=mode)
    rt = ConsensusRuntime(model, ccfg)
    state = rt.init_state()
    args = SimpleNamespace(agents=2, ecns=4, stragglers=1, seed=0, steps=1, batch=16, seq=16)
    batch, alive = next(train.consensus_batches(args, ccfg.code(), cfg.vocab, cfg))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run():
        new, metrics = rt.train_step(state, batch, alive)
        return metrics, [t for key in ("x", "y", "z") for t in new[key].values()]
    return run


@pytest.fixture
def entered(monkeypatch):
    """The names of every ``record_function`` entered while the test runs."""
    names = []
    cls = torch.profiler.record_function
    enter = cls.__enter__

    def counting(self):
        names.append(self.name)
        return enter(self)

    monkeypatch.setattr(cls, "__enter__", counting)
    return names


@pytest.mark.parametrize("mode", list(SPANS))
def test_step_records_its_phase_spans_inside_the_step(mode, entered):
    run = _step(mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    want = SPANS[mode]
    assert {n: entered.count(n) for n in set(entered)} == want
    events = [e for e in prof.events()
              if e.name in want and e.device_type == DeviceType.CPU]
    assert sorted(e.name for e in events) == sorted(n for n, c in want.items()
                                                   for _ in range(c))
    (step,) = [e for e in events if e.name.endswith(".step")]
    for e in events:
        assert e.thread == step.thread, e.name
        assert step.time_range.start <= e.time_range.start, e.name
        assert e.time_range.end <= step.time_range.end, e.name


@pytest.mark.parametrize("mode", ["plain", "incremental"])
def test_untraced_step_enters_no_record_function_and_matches_a_traced_one(mode, entered):
    plain_metrics, plain_tensors = _step(mode)()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced_metrics, traced_tensors = _step(mode)()
    assert entered
    assert set(plain_metrics) == set(traced_metrics)
    for key in plain_metrics:
        assert torch.equal(plain_metrics[key], traced_metrics[key]), key
    assert len(plain_tensors) == len(traced_tensors)
    for a, b in zip(plain_tensors, traced_tensors):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,span", [("plain", "plain.adam"),
                                       ("consensus", "consensus.update")])
def test_train_cli_trace_holds_the_phase_spans(mode, span, tmp_path, capsys):
    path = tmp_path / "steps.json"
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode,
                "--steps", "3", "--batch", "16" if mode == "consensus" else "2",
                "--seq", "16", "--trace", str(path)])
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(e.get("name") == span for e in events) == 2  # steps 1 and 2
    assert sum(e.get("name") == f"{mode}.step" for e in events) == 2
    assert f"trace of steps 1-2 written to {path}" in capsys.readouterr().out


def test_train_cli_trace_needs_three_steps(tmp_path):
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                    "--trace", str(tmp_path / "t.json")])
