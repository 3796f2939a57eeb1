"""One cell, one run: the cell's files found by name, set-up, the timed
window, the traced window, the check against the plain reference, and
the result line.

Nothing here names a cell, a family, a mix or a metric: a cell of
BENCHMARK.json names its configuration (``configs/<name>.json``, whose
``model.family`` names ``reference/<family>.py``) and its mix
(``traffic/<name>.json``, whose ``runtime`` names ``runtimes/<runtime>.py``);
each metric is read by ``metrics/<name>.py``; the limits of the numbers
compared are ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.reference.common import exact_float32

__all__ = ["ROOT", "PKG", "BANNED", "Cell", "Record", "load_spec", "reader", "resolve",
           "cuda_cards", "peak_bytes", "run_cell", "check", "banned_modules", "device_info"]

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
PROFILED_STEPS = 2


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    runtime: object
    family: object
    end_to_end: List[Tuple[dict, object]]
    per_layer: List[Tuple[dict, object]]
    limits: Optional[Dict[str, float]]


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    cell: Cell
    setup_s: float
    window_s: float
    steps: int
    peak_bytes: int
    trace: object = None


def load_spec(path: Optional[pathlib.Path] = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    key = f"portbench.metrics.{name}"
    if key not in sys.modules:
        path = PKG / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"metric {name!r} has no reader {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, spec: Optional[dict] = None, *, config: Optional[dict] = None,
            traffic: Optional[dict] = None, limits: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of BENCHMARK.json with everything it names;
    ``config``/``traffic``/``limits`` replace the files' contents (tests
    run a cell at a smaller size)."""
    spec = spec or load_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    if config is None:
        config = json.loads((ROOT / cfg_entry["file"]).read_text())
    if traffic is None:
        traffic = json.loads((PKG / "traffic" / f"{entry['traffic']}.json").read_text())
    if limits is None:
        path = PKG / "limits" / f"{workload}.json"
        limits = json.loads(path.read_text())["limits"] if path.is_file() else None
    return Cell(
        name=workload, entry=entry, config=config, traffic=traffic,
        runtime=importlib.import_module(f"portbench.runtimes.{traffic['runtime']}"),
        family=importlib.import_module(f"portbench.reference.{config['model']['family']}"),
        end_to_end=[(m, reader(m["name"])) for m in spec["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[(m, reader(m["name"])) for m in spec["per_layer"] if _applies(m, workload)],
        limits=limits,
    )


def cuda_cards(cell: Cell, device) -> List[int]:
    """The CUDA cards the cell runs on, as many as it asks for; none on
    the CPU."""
    return list(range(cell.entry["chips"])) if torch.device(device).type == "cuda" else []


def peak_bytes(cards: List[int], read=None) -> int:
    """The fullest card's peak of allocated bytes (``read``: a card's
    peak, ``torch.cuda.max_memory_allocated`` by default); 0 with no card."""
    read = read or torch.cuda.max_memory_allocated
    return max((read(c) for c in cards), default=0)


def _sync(cards: List[int]) -> None:
    """Wait for every card of the cell."""
    for c in cards:
        torch.cuda.synchronize(c)


def check(cell: Cell, seed: int, device, readings) -> Dict[str, dict]:
    """The plain reference's readings of the same steps against the
    program's: name -> {value, limit, at}, the held numbers first."""
    with exact_float32():
        ref = cell.runtime.reference(cell, seed, device)
    out = {}
    for name, (value, at) in cell.runtime.compare(readings, ref).items():
        limit = (cell.limits or {}).get(name)
        out[name] = {"value": value, "limit": limit, "at": at}
    return dict(sorted(out.items(), key=lambda kv: kv[1]["limit"] is None))


def _passes(checks: Dict[str, dict]) -> bool:
    """Every number the cell holds is within its limit (and at least one
    is held); a number with no limit is reported only."""
    held = [c for c in checks.values() if c["limit"] is not None]
    return bool(held) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in held)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             program_hook=None) -> Tuple[dict, Dict[str, dict]]:
    """Set-up, the window, the traced window when asked, then the check:
    (the result line's object, its checks with where each number was read).
    Set-up ends in a full collection and ``gc.freeze()``; the collector
    scans set-up's objects again once the windows have closed.
    ``t0`` is the ``time.perf_counter()`` of the process's start.
    ``program_hook`` (tests only) may replace parts of the program object
    before set-up's first step."""
    from portbench import trace as tracing

    cards = cuda_cards(cell, device)
    if cards:
        torch.cuda.init()  # a card's memory statistics exist once CUDA is initialised
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    marks = [time.perf_counter()]
    program = cell.runtime.Program(cell, seed, device)
    if program_hook is not None:
        program_hook(program)
    _sync(cards)
    marks.append(time.perf_counter())
    readings = cell.runtime.warm_up(program, cell, seed)
    _sync(cards)
    # What set-up leaves alive (imports, the program, its state) is kept out
    # of the collector's scans while steps are timed: a full collection over
    # it stalls the host, which paces the step, every tenth step or so.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    setup = {"imports_s": marks[0] - t0, "program_s": marks[1] - marks[0],
             "first_steps_s": t0 + setup_s - marks[1], "each_first_step_s": readings.step_s}

    try:
        steps = failed = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            loss = program.step()
            steps += 1
            failed += not math.isfinite(loss)
        _sync(cards)
        window_s = time.perf_counter() - start
        peak = peak_bytes(cards)

        trace = None
        if traced:
            ops = [op for _, r in cell.per_layer for op in getattr(r, "INSTRUMENT", ())]
            trace = tracing.profile_steps(program.step, PROFILED_STEPS, ops, len(cards))
    finally:
        gc.unfreeze()
    program.close()
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    record = Record(cell, setup_s, window_s, steps, peak, trace)
    metrics = {}
    for entry, rd in (cell.per_layer if traced else cell.end_to_end):
        value = rd.read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    t_check = time.perf_counter()
    checks = check(cell, seed, device, readings)
    check_s = time.perf_counter() - t_check
    result = {
        "correct": failed == 0 and _passes(checks),
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(cell, peak, trace),
    }
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["timing"] = {**setup, "reference_s": check_s,
                        "profiled_wall_s": trace.wall_s if trace else None}
    result["unheld"] = {n: c["value"] for n, c in checks.items() if c["limit"] is None}
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                        for n, c in checks.items() if c["limit"] is not None}
    return result, checks


def _power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(cell: Cell, peak: int, trace) -> dict:
    cuda = torch.cuda.is_available()
    info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.entry["chips"],
        "memory_peak_bytes": peak,
        "power_limit_w": _power_limit_w() if cuda else None,
    }
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
