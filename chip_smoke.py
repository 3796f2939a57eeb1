#!/usr/bin/env python3
"""Smoke test of `repro_torch` on one NVIDIA GPU: build, kernels, main path.

Run from the repository root, on a machine with a CUDA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result):

1. build    — compile the CUDA sources of `repro_torch.kernels` (nvcc,
              sm_90a) and print the build time and ptxas report.
2. kernels  — every kernel of the main path against its plain PyTorch
              version on the card, in f32, f64 and bf16, with NaN planted
              in dead message rows, at the fig5 step (R=16, J=6, n=3), the
              USPS step (R=9, J=3, n=640) and a fleet-scale step at the
              paper's USPS width p=256 x d=10 (R=4096, J=16, n=2560).
              Times from CUDA events, the memory bound, and the plain
              version's time; for the combine also one `torch.bmm` on
              pre-masked messages as a yardstick.
3. fig5     — the paper's fig5 sweep at its registry defaults (1200 iters,
              S in {0,1,2,3} x 4 seeds = 16 runs) through `run_sweep` on
              the GPU in f64, held per run against the same sweep on the
              CPU, with the fused kernel's launch count checked.
4. fig3_stragglers — one seed in f32 on the GPU (n = 640, the K=3 and K=4
              groups), held against the CPU in f64.

Before the last line it prints a ``{"kernels": [...]}`` JSON line and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. With no GPU, or without the rest of the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# Peak rate outside the tensor cores, by accumulation type (NVIDIA H100
# SXM data sheet): 67 TFLOP/s float32, 34 TFLOP/s float64.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# Kernel-vs-plain tolerance by OUTPUT dtype, normwise
# (max |kernel - plain| <= tol * max(max |plain|, 1)), at the reference's
# kernel-test levels (tests/test_kernels.py): f64 1e-12, f32 1e-5, bf16
# 2e-2 (a few bf16 ulps). Both sides read the same bf16 inputs and
# accumulate in f32, so only the bf16-rounded output of the update gets
# the bf16 level; the combine's f32 output from bf16 messages is held at
# f32 round-off, which a kernel accumulating in bf16 would miss.
KERNEL_TOL = {
    torch.float64: 1e-12,
    torch.float32: 1e-5,
    torch.bfloat16: 2e-2,
}
KERNEL_SHAPES = {
    "fig5_step": (16, 6, 3),
    "usps_step": (9, 3, 640),
    "fleet_step": (4096, 16, 2560),
}
SOURCE = "src/repro_torch/kernels/csrc/coded_combine.cu"
REPLACES = {
    "coded_admm_update": "src/repro/kernels/coded_combine.py:104",
    "coded_combine": "src/repro/kernels/coded_combine.py:57",
}
TRACE_FIELDS = ("accuracy", "test_error", "z_err", "final_x", "final_z")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back calls,
    from CUDA events (after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_device_ms(fn, reps: int, name: str):
    """Mean device time per launch of kernels whose name contains ``name``,
    from torch.profiler; None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if name in ev.key and dev_us > 0:
            total += dev_us
            count += ev.count
    return total / count / 1e3 if count else None


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def kernel_inputs(R, J, n, dtype, seed):
    """Seeded inputs of one step: msgs (R, J, n) with NaN in the first row
    wherever that row is dead, coeffs/mask (R, J), x/y/z (R, n), tau/rho (R,)."""
    from repro_torch.kernels.ref import compute_dtype

    ct = compute_dtype(dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    msgs = torch.randn(R, J, n, generator=g, device=dev).to(dtype)
    coeffs = torch.randn(R, J, generator=g, device=dev).to(ct)
    mask = (torch.rand(R, J, generator=g, device=dev) > 0.25).to(ct)
    mask[:, 0] = 0.0  # row 0 dead in every run ...
    msgs[:, 0] = float("nan")  # ... and poisoned: it must not leak
    x, y, z = (torch.randn(R, n, generator=g, device=dev).to(dtype) for _ in range(3))
    tau = (torch.rand(R, generator=g, device=dev) * 3 + 0.5).to(ct)
    rho = (torch.rand(R, generator=g, device=dev) + 0.5).to(ct)
    return msgs, coeffs, mask, x, y, z, tau, rho


def bound(kind, R, J, n, dtype, alive_rows):
    """(bound_ms, bound_by) for one call on this call's data: each input
    read once, each output written once, over the memory rate. Dead message
    rows need not be read (the kernel never loads them), so only the
    ``alive_rows`` of the R * J count. 2 flops per alive message element
    (+6 per output for the update) over the peak rate."""
    from repro_torch.kernels.ref import compute_dtype

    ct = compute_dtype(dtype)
    es, cs = torch.finfo(dtype).bits // 8, torch.finfo(ct).bits // 8
    nbytes = alive_rows * n * es + 2 * R * J * cs  # msgs, coeffs, mask
    flops = 2 * alive_rows * n
    if kind == "coded_admm_update":
        nbytes += 3 * R * n * es + 2 * R * cs + R * n * es  # x,y,z,tau,rho,out
        flops += 6 * R * n
    else:
        nbytes += R * n * cs  # out in the accumulation dtype
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[ct] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build("coded_combine")
    seconds = time.perf_counter() - t0
    log(f"[build] {lib.name} in {seconds:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")


def phase_kernels():
    """Kernel vs plain version at every shape and dtype; returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_combine import (
        coded_admm_update_kernel,
        coded_combine_kernel,
    )

    rows = []
    seed = 0
    for shape_name, (R, J, n) in KERNEL_SHAPES.items():
        reps = 20 if R * J * n > 1e7 else 200
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            seed += 1
            msgs, coeffs, mask, x, y, z, tau, rho = kernel_inputs(
                R, J, n, dtype, seed
            )
            masked = torch.where(
                mask[..., None] > 0, msgs.to(coeffs.dtype), 0.0
            )
            alive_rows = int((mask > 0).sum().item())
            calls = {
                "coded_admm_update": (
                    lambda: coded_admm_update_kernel(
                        msgs, coeffs, mask, x, y, z, tau, rho
                    ),
                    lambda: ref.coded_admm_update_ref(
                        msgs, coeffs, x, y, z, tau, rho, mask
                    ),
                    None,
                ),
                "coded_combine": (
                    lambda: coded_combine_kernel(msgs, coeffs, mask),
                    lambda: ref.coded_combine_ref(msgs, coeffs, mask),
                    lambda: torch.bmm(coeffs[:, None, :], masked)[:, 0],
                ),
            }
            for name, (kern, plain, lib) in calls.items():
                out, want = kern(), plain()
                torch.cuda.synchronize()
                err = max_err(out, want)
                tol = KERNEL_TOL[want.dtype]
                scale = max(want.double().abs().max().item(), 1.0)
                ok = (
                    out.dtype == want.dtype
                    and out.shape == want.shape
                    and bool(torch.isfinite(out).all())
                    and err <= tol * scale
                )
                row = dict(
                    name=name, shape=shape_name, R=R, J=J, n=n,
                    dtype=str(dtype).replace("torch.", ""),
                    alive_rows=alive_rows, max_abs_err=err, tol=tol * scale,
                    ms=cuda_ms(kern, reps),
                    device_ms=profiled_device_ms(kern, reps, "coded_kernel"),
                    plain_ms=cuda_ms(plain, reps),
                    library_ms=None if lib is None else cuda_ms(lib, reps),
                )
                row["bound_ms"], row["bound_by"] = bound(
                    name, R, J, n, dtype, alive_rows
                )
                log("[kernels] " + json.dumps(row))
                rows.append(row)
                if not ok:
                    raise AssertionError(
                        f"{name} {shape_name} {dtype}: kernel disagrees with "
                        f"its plain version (max abs err {err:.3e} > "
                        f"{tol * scale:.3e}, dtype {out.dtype}/{want.dtype}, "
                        f"finite={bool(torch.isfinite(out).all())})"
                    )
            del msgs, coeffs, mask, x, y, z, tau, rho, masked
    return rows


def compare_traces(label, got, want, rtol, atol=1e-12):
    """Per-run, per-field comparison of two sweeps' traces, normwise:
    max |got - want| <= atol + rtol * max |want| over each run's field.
    Returns the worst normwise relative gap; raises beyond the tolerance."""
    worst = 0.0
    for case, a, b in zip(got.cases, got.traces, want.traces):
        for field in TRACE_FIELDS:
            x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
            if x.shape != y.shape or not np.isfinite(x).all():
                raise AssertionError(
                    f"{label} {case.label('S', 'seed')} {field}: shape "
                    f"{x.shape} vs {y.shape}, finite={np.isfinite(x).all()}"
                )
            gap = float(np.abs(x.astype(np.float64) - y).max())
            scale = float(np.abs(y).max())
            worst = max(worst, gap / max(scale, 1e-300))
            if gap > atol + rtol * scale:
                raise AssertionError(
                    f"{label} {case.label('S', 'seed')} {field}: GPU vs CPU "
                    f"gap {gap:.3e} beyond {atol:.0e} + {rtol:.0e} x {scale:.3e}"
                )
    return worst


def phase_fig5():
    from repro_torch.experiments import get_sweep, run_sweep
    from repro_torch.kernels.coded_combine import LAUNCHES

    spec = get_sweep("fig5")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    gpu = run_sweep(spec, device="cuda", dtype=torch.float64)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    iters = gpu.cases[0].iters
    log(
        f"[fig5] cuda f64: {len(gpu.cases)} runs x {iters} iters in "
        f"{gpu.n_dispatches} group(s), wall {wall:.3f} s, launches {launches}"
    )
    if launches["coded_admm_update"] != iters * gpu.n_dispatches:
        raise AssertionError(
            f"fig5 launched the fused kernel {launches['coded_admm_update']} "
            f"times, want {iters} x {gpu.n_dispatches} groups"
        )
    t0 = time.perf_counter()
    cpu = run_sweep(spec, device="cpu", dtype=torch.float64)
    log(f"[fig5] cpu f64 reference wall {time.perf_counter() - t0:.3f} s")
    # Same f64 algorithm on two devices: the gaps are summation order
    # (cuBLAS vs CPU batched products) and FMA contraction in the kernel,
    # damped by the contractive iteration.
    worst = compare_traces("fig5", gpu, cpu, rtol=1e-9)
    log(f"[fig5] GPU vs CPU worst normwise gap {worst:.3e} (tolerance 1e-9)")
    final = {}
    for S in sorted({c.S for c in gpu.cases}):
        accs = [t.accuracy[-1] for c, t in gpu.select(S=S)]
        final[S] = float(np.mean(accs))
    order = [final[S] for S in sorted(final)]
    log(
        "[fig5] final accuracy (eq. 23, mean of seeds) per S: "
        + json.dumps(final)
        + f"; larger S converges more slowly (Corollary 2): "
        f"{all(a <= b for a, b in zip(order, order[1:]))}"
    )
    return launches


def phase_fig3_stragglers():
    from repro_torch.experiments import get_sweep, run_sweep
    from repro_torch.kernels.coded_combine import LAUNCHES

    spec = get_sweep("fig3_stragglers", runs=1)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    gpu = run_sweep(spec, device="cuda", dtype=torch.float32)
    wall = time.perf_counter() - t0
    iters = gpu.cases[0].iters
    log(
        f"[fig3_stragglers] cuda f32: {len(gpu.cases)} runs x {iters} iters "
        f"in {gpu.n_dispatches} group(s), wall {wall:.3f} s, launches "
        f"{dict(LAUNCHES)}"
    )
    if LAUNCHES["coded_admm_update"] != iters * gpu.n_dispatches:
        raise AssertionError("fig3_stragglers bypassed the fused kernel")
    cpu = run_sweep(spec, device="cpu", dtype=torch.float64)
    # f32 on the GPU against f64 on the CPU: float32 round-off (6e-8 per
    # operation) through 1500 contractive iterations, and the test error's
    # Gram-form cancellation (z'Gz - 2<z,C> + ||T||^2), which scales with
    # the trace's largest value — hence a normwise bound. On the CPU the
    # same f32-vs-f64 comparison gives at most 2.8e-6.
    worst = compare_traces("fig3_stragglers", gpu, cpu, rtol=1e-4)
    log(
        f"[fig3_stragglers] GPU f32 vs CPU f64 worst normwise gap "
        f"{worst:.3e} (tolerance 1e-4)"
    )


def main() -> int:
    if not torch.cuda.is_available():
        print(
            "chip_smoke: torch.cuda.is_available() is False; this smoke test "
            "needs a CUDA GPU",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    # Full-precision float32 products: the port is held to f32 round-off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(
        f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}"
    )
    phase_build()
    rows = phase_kernels()
    launches = phase_fig5()
    phase_fig3_stragglers()

    main_row = {
        r["name"]: r for r in rows
        if r["shape"] == "fig5_step" and r["dtype"] == "float64"
    }
    kernels = [
        dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name],
            **{k: main_row[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "shape", "dtype",
            )},
        )
        for name in ("coded_admm_update", "coded_combine")
    ]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
