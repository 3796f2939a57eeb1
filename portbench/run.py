"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With ``--trace 0`` the line carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a profiled window of whole steps after the unprofiled one, and a
breakdown of device time and idle gaps. Every run checks what its own
set-up steps produced against the plain reference and prints each number
compared beside its limit, last on standard error and last in the line.

Exits non-zero and prints no line when there is no CUDA card (or fewer
than the cell asks for), when the program cannot be imported, or when
JAX or the JAX package has been loaded by the time the result is ready.
Build and kernel caches stay inside the checkout: the port's nvcc builds
in ``src/repro_torch/kernels/_build/``, Triton's and PyTorch's extension
caches under ``.portbench_cache/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.entry['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T0)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: modules the benchmark may not load were loaded: {banned}",
              file=sys.stderr)
        return 3
    for held in (False, True):  # the numbers held to a limit print last
        for name, c in checks.items():
            if (c["limit"] is not None) == held:
                limit = f"limit {c['limit']!r}" if held else "not held"
                print(f"check {name} {c['value']!r} {limit} (at {c['at']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
