"""Readings that the limits of a cell's numbers are set from: not part of
a benchmark run.

For each seed: the program's set-up steps and their readings (a sound
run), the float32 reference's readings, and the numbers compared between
them (the lower readings). For the first ``--control`` seeds also: the
control, the reference computed with fp8 products put in the program's
place (the upper readings), and the planted faults: half of each agent's
rows left out with the mean taken over the rest (in the reference), and,
on a mix of several cards, the exchange between cards left out (in the
program, ``no_exchange``); a state left unchanged reads 1 by the
comparison's measure and needs no run. Training needs no measured window.

The program's seeds run one after another in this process, on the cell's
cards. The references then run on each of those cards at once: one
process a card (``CUDA_VISIBLE_DEVICES``), each taking every
``chips``-th seed, reading the program's readings from a file.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control 3 \\
        --out calibrate.jsonl
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAULTS = ("half_batch",)


def no_exchange(program):
    """Plant the fault 'the exchange between cards left out' in a consensus
    program of an incremental mix: the committing agent's z-delta reaches
    only the copy of z on its own card, and every other card's copy keeps
    what it held before the step."""
    rt = program.rt
    step = rt.train_step
    if rt.cfg.mode != "incremental":
        raise ValueError("no_exchange is planted for an incremental mix")

    def faulty(state, batch, alive):
        A, D = rt.cfg.n_agents, len(rt.devices)
        before = [dict(state["z"]), *(dict(z) for z in state.get("z_rep", ()))]
        new, metrics = step(state, batch, alive)
        own = (new["k"] - 1) % A % D  # the card of this step's committing agent
        after = [new["z"], *new.get("z_rep", ())]
        kept = [z if d == own else before[d] for d, z in enumerate(after)]
        new["z"] = kept[0]
        if D > 1:
            new["z_rep"] = kept[1:]
        return new, metrics

    rt.train_step = faulty


def program_faults(cell) -> dict:
    """The faults planted in the program that the cell can have."""
    return {"no_exchange": no_exchange} if cell.traffic.get("cards", 1) > 1 else {}


def _free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def program_readings(cell, seed: int, device, control: bool) -> dict:
    """The program's readings of one seed's set-up steps, and with
    ``control`` those of each program fault: name -> Readings."""
    out = {}
    hooks = {"program": None, **(program_faults(cell) if control else {})}
    for name, hook in hooks.items():
        program = cell.runtime.Program(cell, seed, device)
        if hook is not None:
            hook(program)
        out[name] = cell.runtime.warm_up(program, cell, seed)
        program.close()
        del program
        _free(device)
    return out


def against_reference(cell, seed: int, device, progs: dict, control: bool) -> dict:
    """Each of ``progs`` and, with ``control``, the control and each
    reference fault, against the float32 reference."""
    from portbench.reference.common import exact_float32

    with exact_float32():
        ref = cell.runtime.reference(cell, seed, device)
        out = {"seed": seed, "program_loss": progs["program"].loss, "reference_loss": ref.loss}
        for name, readings in progs.items():
            out[name] = cell.runtime.compare(readings, ref)
        if control:
            fp8 = cell.runtime.reference(cell, seed, device, "fp8")
            out["control"] = cell.runtime.compare(fp8, ref)
            for fault in FAULTS:
                bad = cell.runtime.reference(cell, seed, device, "float32", fault)
                out[fault] = cell.runtime.compare(bad, ref)
    return out


def readings(cell, seed: int, device, control: bool) -> dict:
    """The numbers of one seed in one process: the program's, and with
    ``control`` the control's and each fault's, against the reference."""
    progs = program_readings(cell, seed, device, control)
    _free(device)
    return against_reference(cell, seed, device, progs, control)


def _emit(row: dict, out: pathlib.Path) -> None:
    import torch

    row["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(row)
    print(line, flush=True)
    with out.open("a") as f:
        f.write(line + "\n")


def _references(cell, args, out: pathlib.Path) -> None:
    """This process's share of the references: the program's readings
    from ``args.programs``, every ``args.part[1]``-th seed from the
    ``args.part[0]``-th."""
    from portbench.training import Readings

    rows = json.loads(pathlib.Path(args.programs).read_text())
    part, parts = args.part
    for i, row in enumerate(rows):
        if i % parts != part:
            continue
        t = time.perf_counter()
        progs = {n: Readings(**r) for n, r in row["programs"].items()}
        got = against_reference(cell, row["seed"], "cuda", progs, row["control"])
        got["seconds"] = row["seconds"] + time.perf_counter() - t
        _emit(got, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--out", required=True)
    ap.add_argument("--programs", help=argparse.SUPPRESS)  # a reference process's input
    ap.add_argument("--part", type=int, nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.programs:
        _references(cell, args, out)
        return 0
    seeds = [int(s) for s in args.seeds.split(",")]
    cards = len(harness.cuda_cards(cell, "cuda"))
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        progs = program_readings(cell, seed, "cuda", i < args.control)
        rows.append({"seed": seed, "control": i < args.control,
                     "programs": {n: dataclasses.asdict(r) for n, r in progs.items()},
                     "seconds": time.perf_counter() - t})
        print(f"calibrate: program seed {seed} in {rows[-1]['seconds']:.1f} s", flush=True)
    programs = out.with_name(out.name + ".programs.json")
    programs.write_text(json.dumps(rows))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--workload", args.workload, "--out", str(out),
         "--programs", str(programs), "--part", str(c), str(cards)],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": str(c)}) for c in range(cards)]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
