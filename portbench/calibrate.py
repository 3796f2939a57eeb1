"""Readings that the limits of a cell's numbers are set from: not part of
a benchmark run.

For each seed: the program's set-up steps and their readings (a sound
run), the float32 reference's readings, and the numbers compared between
them (the lower readings). For the first ``--control`` seeds also: the
control, the reference computed with fp8 products put in the program's
place (the upper readings), and the planted faults that need a run (half
of each agent's rows left out, the mean taken over the rest); a state
left unchanged reads 1 by the comparison's measure and needs no run.
Training needs no measured window, so all seeds run in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control 3 \\
        --out calibrate.jsonl
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAULTS = ("half_batch",)


def readings(cell, seed: int, device, control: bool) -> dict:
    """The numbers of one seed: the program's, and with ``control`` the
    control's and each fault's, all against the float32 reference."""
    import gc

    import torch

    from portbench.reference.common import exact_float32

    program = cell.runtime.Program(cell, seed, device)
    prog = cell.runtime.warm_up(program, cell, seed)
    program.close()
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    with exact_float32():
        ref = cell.runtime.reference(cell, seed, device)
        out = {"seed": seed, "program": cell.runtime.compare(prog, ref),
               "program_loss": prog.loss, "reference_loss": ref.loss}
        if control:
            fp8 = cell.runtime.reference(cell, seed, device, "fp8")
            out["control"] = cell.runtime.compare(fp8, ref)
            for fault in FAULTS:
                bad = cell.runtime.reference(cell, seed, device, "float32", fault)
                out[fault] = cell.runtime.compare(bad, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--out", required=True)
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
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = readings(cell, seed, "cuda", control=i < args.control)
        row["seconds"] = time.perf_counter() - t
        row["device"] = torch.cuda.get_device_name(0)
        line = json.dumps(row)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
