#!/usr/bin/env python3
"""Smoke test of `repro_torch` on one NVIDIA GPU: build, kernels, main paths.

Run from the repository root, on a machine with a CUDA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result):

1. build    — compile the CUDA sources of `repro_torch.kernels` (nvcc,
              sm_90a, one process per source, all at once), print the
              build times and ptxas reports, and count each K4 kernel's
              HGMMA instructions in `cuobjdump -sass` (the tensor-core
              body's two kernels must hold some); the conv + SiLU
              kernels must be in their library's SASS.
1a. analysis — the port's trace contracts on the card
              (`repro_torch.analysis`): the AST lint of `src/repro_torch`
              (no finding), then the step audit of the reference's ten
              grids in f64, 12 steps a static group: one `[analysis]`
              line a grid with its groups, K1 entries and launches (equal,
              `iters` a step on the coded grids, none on the others),
              host syncs under `torch.cuda.set_sync_debug_mode("error")`
              (none), f64 -> f32 demotions and output dtypes, gated
              against the committed `src/repro_torch/analysis/
              trace_audit.json`.
2. kernels  — every kernel against its plain PyTorch version on the card,
              with times from CUDA events and torch.profiler (which must
              see the kernel by name), the card's bound, the share of it
              reached (bound / device time), the achieved rate (TFLOP/s
              where operations bound the kernel, TB/s where bytes do),
              the plain version's time and, where one PyTorch call
              computes the same function, that call's time:
              K1/K2 (coded combine) in f32, f64 and bf16, with NaN planted
              in dead message rows, at the fig5 step (R=16, J=6, n=3), the
              USPS step (R=9, J=3, n=640), a fleet-scale step at the
              paper's USPS width (R=4096, J=16, n=2560) and the step of
              `fleet_frontier`'s one group (R=12000, J=6, n=3), against
              `torch.bmm`; K3 (flash attention) at the qwen3-0.6b prefill
              step (B 4, S 2048, H 16, KV 8, hd 128) in bf16 and f32, with
              a 512 window, at a ragged S = 1000, at the MQA hd 256 and
              hd 64 instances, and at the granite-4.0-h-micro cell's step
              (B 2, S 8192, H 32, KV 8, hd 64) in bf16, against
              `scaled_dot_product_attention`,
              and (`[attention-scan]`) K3 in bf16 against SDPA at 8192
              tokens over S = 512 .. 8192, causal and not; K5
              (RG-LRU scan) at the recurrentgemma-9b prefill step (B 2,
              S 2048, W 4096) with h0, at a ragged S = 1000 and at
              S = 2049 (one step past a multiple of its chunk); K4 (SSD
              scan) at the mamba2-1.3b training step (B 2, S 4096, H 64,
              P 64, N 128, chunk 256) in bf16 with each body (the
              tensor-core body, which bf16 training runs, in the `_tc`
              rows, also with a head at A = -16, at chunk 128 and 64, and
              at the granite cell's B 2, S 8192; the CUDA-core body, which
              f32 training runs)
              and in f32, at a ragged S = 1000 and at a small shape,
              against the sequential recurrence in f64 (exact), in f32,
              and the chunked form. K4 and K5 have several launches a
              call: a `[kernels] ssd_scan passes` line gives each pass's
              device time, and the passes must account for all the
              device time of the call. The backward kernels against
              their plain twins (``*_bwd_ref``): K3's at the qwen3-0.6b
              training step (B 4, S 2048, H 16, KV 8, hd 128, causal) in
              bf16 and f32 and at recurrentgemma-9b's (B 1, S 4096, H 16,
              KV 1, hd 256, window 2048) and at the granite cell's (B 2,
              S 8192, H 32, KV 8, hd 64) in bf16, against the backward of
              `scaled_dot_product_attention` (`enable_gqa`) at the same
              shape; K4's at the mamba2 cells' call (B 8, S 2048) and the
              granite cell's (B 2, S 8192) against its f64 twin; K5's at
              (1, 4096, 4096) f32 with h0 and dh_last. The Mamba-2
              mixer's conv + SiLU (`[kernels] causal_conv_silu*`) at the
              mamba2 cells' call (B 8, S 2048, C 4352, W 4) and the
              granite cell's (B 2, S 8192), bf16, read through the
              in-projection's column slice: the forward bit for bit the
              plain expression, the backward's gradients against the f64
              twin within 2 x the gap of autograd of the expression, the
              same bits on a
              second run, each beside its bytes bound and the plain
              expression's time (forward; autograd of it, backward).
3. fig5     — the paper's fig5 sweep at its registry defaults (1200 iters,
              S in {0,1,2,3} x 4 seeds = 16 runs) through `run_sweep` on
              the GPU in f64, held per run against the same sweep on the
              CPU, with the fused kernel's launch count checked.
4. fig3_stragglers — one seed in f32 on the GPU (n = 640, the K=3 and K=4
              groups), held against the CPU in f64.
5. baselines — the paper's comparison at registry size, in f64 on the
              card, each sweep held run by run against the same sweep on
              the CPU (normwise 1e-9; host clocks and communication counts
              bitwise): `fig3_baselines` (1500 iterations, the gossip
              groups 150), `fig4_baselines` (1200) and `fig3e_runtime`
              (1500, 2 seeds). K1 launches `iters` times in each group of
              a K1 method (sI/csI/pI/cq-sI-ADMM) and never in a W-ADMM or
              gossip group; each group's wall time on the card and the
              CPU; per method the final accuracy and where it first
              reaches accuracy 0.15 (iteration, communication, simulated
              time); a profile of `fig3_baselines` at 100 iterations.
6. variants — `privacy_grid` (pI-ADMM, 800 iterations x 8 cells x 3
              seeds) and `compression_grid` (cq-sI-ADMM, 800 x 9 x 3) as
              above; then on the card, bit for bit against sI-ADMM in a
              batch of the same shape, pI-ADMM at sigma = 0 and top-k at
              frac = 1.
7. grids    — `topology_grid`, `hetero_grid`, `code_frontier` (800
              iterations) and `mesh_scale` (600) as above, with a profile
              of `mesh_scale` at 100 iterations.
7a. fleet   — `fleet_frontier` at registry size (2 responses x 3 code
              families x 2 S x 1,000 seeds = 12,000 runs x 1,000
              iterations, one group) through `run_sweep` with its
              streaming Reduction on the card in f64 (runs are cut, and
              the cut logged, only if the host cannot hold the stacked
              arrays): host prepare, stacking, host-to-device copy and step
              loop timed apart, run-iterations per second, a profiled
              50-step copy of the loop (busy share), peak device memory and
              host RSS; K1 launched `iters` times. Its first 2 seeds (24
              runs) are held against the same sweep on the CPU: continuous
              summaries normwise 1e-9, discrete ones (time-to-target,
              quantiles) equal unless the metric lies within 1e-9 of a
              target or bin edge (counted and printed).
7b. sharded — `run_sharded` with the card listed twice, under a
              REPRO_SHARD_MEM_MB that forces at least three chunks, on a
              60-run slice of `fleet_frontier`: the lazy reduced path
              (summaries at 1e-12) and the Trace path (bit for bit), each
              against `run_batch` on the card.
7c. async   — `staleness_frontier` (8 groups) and `churn_grid` (2) at
              registry size, card against CPU; the tau_max = 0 and
              churn_rate = 0 arms bit for bit against a sync-only sweep of
              the same cases (a batch of the same shape).
7d. adaptive — `adaptive_frontier` at registry size, card against CPU;
              `device_pulls` on the card equal to the host `replay` for
              UCB1 and EXP3; single-arm controllers equal to the static
              csI-ADMM run bit for bit.
8. serve-qwen3 — `repro_torch.launch.serve.serve` on qwen3-0.6b at full
              width and depth in bf16: batch 4, prompt 2048, 32 new tokens.
              K3 launches exactly once per layer of the one prefill (28)
              and never in decode. Then, on the same weights: a warm
              prefill's wall time without the profiler, a profile
              of a warm prefill and of 3 decode steps (device busy share,
              top kernels), and the prefill's logits and cache on the
              kernel path held against the plain path on the card, in
              bf16 and with the model widened to f32.
9. serve-rg — the same for recurrentgemma-9b (batch 2, prompt 2048, 16
              new tokens): K5 launches once per recurrent layer (26), K3
              once per attention layer (12).
9a. serve-granite — the same for granite-4.0-h-micro at full size (batch
              2, prompt 8192, 32 new tokens): K3 once per attention layer
              (4), the conv + SiLU kernel once per Mamba layer (36); its
              Mamba layers' prefill runs `ssd_chunked`.
10. train-mamba2 — mamba2-1.3b at full width and depth (48 layers, 1.34 B
              parameters), batch 2 x 4096 tokens, remat "full": the loss
              and every parameter's gradient on the kernel path held
              against the plain path (``ssd_chunked``) from the same
              weights and batch, in bf16 (K4's tensor-core body, within
              2 x the spread of plain bf16 vs plain f32) and widened to
              f32 (its CUDA-core body, TRAIN_TOL), with K4's launches
              counted (2 per layer: forward and recomputation; none on
              the plain path), and the conv + SiLU kernel's (forward 2,
              backward 1 per layer); then 5 Adam steps through the training
              entry point (`repro_torch.launch.train.main`) in bf16, with
              per-step losses, the warm step time, peak device memory and
              a profile of one more warm step, in which each pass of the
              tensor-core body runs 96 times (and the CUDA-core body's
              never), with K4's device time. Every profile names the
              port's kernels on its path. Then the f64 witness (ROADMAP
              Queue 3 item 1), over 2 seeds: the plain path in f64 from
              the bf16 weights widened, and against it the plain path,
              the CUDA-core body and the tensor-core body in bf16 (each
              body forced for its reading), worst leaf and normwise over
              all parameters, token NLLs beside them; a body passes when
              both readings are within 2 x the plain path's on both
              seeds, and the body that bf16 training runs must pass; the
              CUDA-core body is held within 5e-2 of plain bf16 on both.
10a. train-qwen3 — qwen3-0.6b at full size (28 layers), bf16, batch 4 x
              2048, remat "full": loss and gradients on the kernel path
              against the plain path, in f32 (TRAIN_TOL) and in bf16
              within 2 x the spread between the plain path in bf16 and
              in f32 from the same weights (printed beside each
              reading); K3's forward launches twice and its backward once
              per layer; then 5 Adam steps through the training entry
              point, peak memory and a profile of one warm step.
10b. train-rg — recurrentgemma-9b at full width cut to 6 layers (two
              [rec, rec, attn] groups, the cut printed), bf16, batch 1 x
              4096: the same checks, with K3 and K5 forward and backward
              launches, then 5 Adam steps through `run_plain`.
10c. consensus-mamba2, consensus-qwen3 — csI-ADMM training at full size
              through `launch.train.run_consensus` (A 2, K 4, S 1,
              cyclic, P_rows 1, seq 2048): 5 incremental steps and 1
              parallel step with losses, residuals, step seconds, peak
              memory and K3/K4 launches (mamba2: the conv + SiLU kernel's
              with K4's); then one more step, checked: (i)
              the agent that does not commit keeps x and y bit for bit;
              (ii) z+ - z equals (1/A) sum mask delta recomputed in f64,
              within 2 ulps of z's dtype; (iii) two one-straggler alive
              masks give the same z+ and (iv) the kernel route the plain
              route's, within 2 x the spread of correct paths.
10d. MoE and VLM (`phase_moe_vlm`), full width, cut in depth (each cut
              logged), bf16, random weights from seed 0:
              serve-phi35 — phi3.5-moe at 16 of 32 layers, batch 4,
              prompt 2048, 32 new tokens, K3 16 launches a prefill; the
              kernel path against the plain path layer by layer from the
              same input (the share of tokens whose top-k expert set
              differs, those whose drops differ, the normwise gap over
              the agreeing tokens at SERVE_TOL), one layer's MoE FFN
              time and share of the prefill; then an f32 model of 2
              layers, whole prefill kernel vs plain at CARD_VS_CPU_TOL;
              serve-mixtral — mixtral-8x22b at 8 of 56 layers, batch 1,
              prompt 8192 (twice the 4096 window: the ring cache wraps),
              16 new tokens, the same layer-by-layer check;
              serve-qwen2vl — qwen2-vl-72b at 8 of 80 layers with its
              vision stub, batch 2, prompt 2048, 16 new tokens, checked as
              serve-qwen3 (bf16 and f32);
              train-phi35 — phi3.5-moe at 2 layers, batch 2 x 2048, as
              train-rg (the routers' gradients among those held), with
              the MoE FFN's forward and backward times;
              consensus-phi35 — phase 10c on phi3.5-moe at 2 layers, the
              incremental run's state and the checks' copies on the host
              while the card holds the rest.
              `[kernels]` holds K3 at the three prefill shapes and its
              backward at train-phi35's.
10e. Whisper (`phase_whisper`), whisper-medium at full size (24 + 24
              layers, 1,500 stand-in frames a row), bf16, seed 0; no
              kernel runs on its path (its attention is the plain path,
              as in the reference), and every phase asserts zero launches:
              serve-whisper — batch 8, prompt 192, 64 new tokens, with
              the warm prefill, decode and their profiles;
              train-whisper — 5 Adam steps through the training entry
              point at batch 8 x 448 (remat "full"), peak memory and a
              warm-step profile; then remat "dots" against "full" (loss
              and gradients of one step, printed bit for bit or by their
              gap; 2 warm Adam steps each with peak memory), on Whisper
              and on qwen3-0.6b at 4 x 2048 (K3 forward 56, backward 28
              under both);
              consensus-whisper — phase 10c at 16 rows of 448 tokens with
              frames.
10f. train-granite — granite-4.0-h-micro at full size at its benchmark
              cell's step (bf16, batch 2 x 8192, remat "full"): 3 Adam
              steps through the training entry point (launches, losses,
              warm step, peak memory), one more step of its runtime with
              the launch counts zeroed just before it (K4's tensor-core
              forward 72 and backward 36, the conv + SiLU kernel's the
              same, K3's forward 8 and backward 4),
              a profile of one warm step; then kernel vs plain loss and
              gradients at full width cut to 6 layers (5 Mamba, 1
              attention) at the same rows, in bf16 and f32, as train-rg.
11. card-vs-cpu — qwen3-0.6b at full width with 2 layers in f32 (batch 1,
              prompt 256), the recurrentgemma smoke config at head
              dim 64 (the smallest K3 takes) and whisper-medium at full
              width with 2 + 2 layers in f32 (batch 1, 1,500 random
              frames, prompt 128): prefill
              and 3 decode steps on the card (kernels) held against the
              port on the CPU (plain versions), logits and caches; and
              3 training steps of the mamba2 and whisper smoke configs in
              f32, losses and final parameters.

Not in the default run (they need several cards): ``phase_multi_card()``,
the sharded tier over every card of the host against one card, and
``phase_multi_card_consensus()``, consensus-qwen3 with four agents, one a
card, against the same run on card 0.

Before the last line it prints a ``{"kernels": [...]}`` JSON line and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. With no GPU, or without the rest of the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.work import flash_attention as attention_work
from portbench.work import ssd_scan as ssd_work
from portbench.work.roofline import HBM_BYTES_PER_S, bound_s

ROOT = os.path.dirname(os.path.abspath(__file__))
# Peak rate outside the tensor cores, by accumulation type (NVIDIA H100
# SXM data sheet): 67 TFLOP/s float32, 34 TFLOP/s float64. The memory rate
# and the peaks of products are the benchmark's (`portbench.work.roofline`).
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
    # fleet_frontier's one group at registry size: 12,000 runs, J = K = 6
    # partitions, n = p d = 3 (the synthetic set).
    "fleet_frontier_step": (12000, 6, 3),
}
# The kernels' names as the profiler sees them (K3: the bf16 tensor-core
# body and the f32 CUDA-core body).
K12_KERNELS = ("coded_kernel",)
K3_KERNELS = ("flash_attention_tc_kernel", "flash_attention_kernel")
SOURCES = {
    "coded_admm_update": "src/repro_torch/kernels/csrc/coded_combine.cu",
    "coded_combine": "src/repro_torch/kernels/csrc/coded_combine.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rglru_scan_bwd": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "causal_conv_silu": "src/repro_torch/kernels/csrc/causal_conv.cu",
    "causal_conv_silu_bwd": "src/repro_torch/kernels/csrc/causal_conv.cu",
}
# The TPU kernel each port kernel replaces; a backward kernel names the TPU
# kernel whose gradient it gives (the TPU kernels have none: the reference
# differentiates its jnp paths).
REPLACES = {
    "coded_admm_update": "src/repro/kernels/coded_combine.py:104",
    "coded_combine": "src/repro/kernels/coded_combine.py:57",
    "flash_attention": "src/repro/kernels/flash_attention.py:98",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:63",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:79",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:98",
    "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:63",
    "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:79",
    # No TPU kernel: the reference's conv + SiLU is jnp code XLA fuses.
    "causal_conv_silu": "none (src/repro/models/mamba2.py:204, jnp)",
    "causal_conv_silu_bwd": "none (src/repro/models/mamba2.py:204, jnp)",
}
# K3 shapes: (B, S, H, KV, hd, window, dtype). The first two are the
# qwen3-0.6b prefill step of [serve-qwen3]; hd 256 with one kv head is
# recurrentgemma-9b's attention shape.
ATTN_SHAPES = {
    "qwen3_step": (4, 2048, 16, 8, 128, None, torch.bfloat16),
    "qwen3_step_f32": (4, 2048, 16, 8, 128, None, torch.float32),
    "window512": (4, 2048, 16, 8, 128, 512, torch.bfloat16),
    "ragged1000": (4, 1000, 16, 8, 128, None, torch.bfloat16),
    "mqa_hd256": (2, 2048, 16, 1, 256, 2048, torch.bfloat16),
    "hd64_f32": (2, 1000, 8, 2, 64, None, torch.float32),
    # The prefill steps of [serve-phi35] (GQA 4), [serve-mixtral] (GQA 6,
    # window 4096 over 8192 tokens) and [serve-qwen2vl] (H 64, GQA 8).
    "phi35_step": (4, 2048, 32, 8, 128, None, torch.bfloat16),
    "mixtral_step": (1, 8192, 48, 8, 128, 4096, torch.bfloat16),
    "qwen2vl_step": (2, 2048, 64, 8, 128, None, torch.bfloat16),
    # granite-4.0-h-micro's attention in its benchmark cell's step (2 rows
    # of 8192, GQA 4, hd 64, no window); the model scales q so that K3's
    # 1 / sqrt(hd) gives its 1/64.
    "granite_step": (2, 8192, 32, 8, 64, None, torch.bfloat16),
}
# K5 shapes: (B, S, W, with h0). The first is recurrentgemma-9b's prefill
# step of [serve-rg] (the model passes a zero h0).
SCAN_SHAPES = {
    "rg_step": (2, 2048, 4096, True),
    "ragged1000": (2, 1000, 4096, False),
    "ragged2049": (2, 2049, 4096, True),  # one step past a multiple of the chunk
}
# K5's launches, as the profiler names them.
K5_KERNELS = ("rglru_scan_reset_kernel", "rglru_scan_kernel")
# The backward kernels' shapes: K3 (B, S, H, KV, hd, window, dtype) at the
# qwen3-0.6b training step of [train-qwen3] (bf16, and in f32 for the
# round-off check) and at recurrentgemma-9b's attention in [train-rg] (hd
# 256, MQA, window 2048 < S); K5 (B, S, W) at [train-rg]'s step.
ATTN_BWD_SHAPES = {
    "qwen3_train": (4, 2048, 16, 8, 128, None, torch.bfloat16),
    "qwen3_train_f32": (4, 2048, 16, 8, 128, None, torch.float32),
    "rg_train": (1, 4096, 16, 1, 256, 2048, torch.bfloat16),
    "hd64": (4, 2048, 16, 8, 64, None, torch.bfloat16),  # the qwen3 step at hd 64
    "phi35_train": (2, 2048, 32, 8, 128, None, torch.bfloat16),  # [train-phi35]'s step
    "granite_train": (2, 8192, 32, 8, 64, None, torch.bfloat16),  # the granite cell's step
}
# The plain backward holds four (B, H, S, S) float32 tensors; above this
# many bytes each it runs one row of the batch at a time (granite_train:
# 16 GiB a tensor at the whole batch).
ATTN_BWD_PLAIN_BYTES = 8 * 2**30
SCAN_BWD_SHAPES = {"rg_train": (1, 4096, 4096)}
# K3's backward: prep, the main body (bf16: the tensor-core body; f32: the
# CUDA-core body), finish.
K3_BWD_KERNELS = ("flash_attention_bwd_prep_kernel", "flash_attention_bwd_tc_kernel",
                  "flash_attention_bwd_kernel", "flash_attention_bwd_finish_kernel")
K5_BWD_KERNELS = ("rglru_scan_reset_kernel", "rglru_scan_bwd_kernel")
# Backward kernel vs its plain twin on the same inputs (the forward's output
# and log-sum-exp included), normwise: K3 in f32 at f32 round-off (other
# summation orders; dQ summed by atomics in any order), in bf16 at a few
# bf16 ulps of the rounded gradients (both compute in f32 from the same
# bf16 values); K5 the same reverse recurrence in f32, chunk by chunk.
ATTN_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SCAN_BWD_TOL = 1e-5
# Kernel vs plain version on the card, normwise: K3 in f32 at f32
# round-off (other summation orders), in bf16 at a few bf16 ulps of the
# output (both read the same bf16 inputs and score in f32); K5 is the same
# sequential recurrence, only FMA contraction differs.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SCAN_TOL = 1e-5
# K4 shapes: (B, S, H, P, N, chunk, dtype, body). "train_step" is the
# mamba2-1.3b training step of [train-mamba2] on the CUDA-core body (which
# f32 training runs), "train_step_tc" the same on the tensor-core body
# (`ssd_scan_tc_kernel`), which bf16 training runs (`ssd_body`).
SSD_SHAPES = {
    "train_step": (2, 4096, 64, 64, 128, 256, torch.bfloat16, "cuda_cores"),
    "train_step_f32": (2, 4096, 64, 64, 128, 256, torch.float32, "cuda_cores"),
    "ragged1000": (2, 1000, 64, 64, 128, 256, torch.bfloat16, "cuda_cores"),
    "small": (1, 200, 2, 16, 32, 64, torch.float32, "cuda_cores"),
    "train_step_tc": (2, 4096, 64, 64, 128, 256, torch.bfloat16, "tensor_cores"),
    "ragged1000_tc": (2, 1000, 64, 64, 128, 256, torch.bfloat16, "tensor_cores"),
    "train_step_a16_tc": (2, 4096, 64, 64, 128, 256, torch.bfloat16, "tensor_cores"),
    "chunk128_tc": (2, 4096, 64, 64, 128, 128, torch.bfloat16, "tensor_cores"),
    "chunk64_tc": (2, 4096, 64, 64, 128, 64, torch.bfloat16, "tensor_cores"),
    # granite-4.0-h-micro's Mamba-2 mixer in its benchmark cell's step (2
    # rows of 8192, mamba2-1.3b's heads)
    "granite_step_tc": (2, 8192, 64, 64, 128, 256, torch.bfloat16, "tensor_cores"),
}
# Shapes whose head 0 has A = -16, mamba2-1.3b's fastest decay (A_log =
# log 16): its 256-step chunks sum a_t to thousands, where a decay factor
# taken as a difference of cumulative sums loses its digits.
SSD_A16 = ("train_step_a16_tc",)
# K4's backward kernel at the benchmark cells' calls (B, S, H, P, N, chunk),
# bf16: the mamba2 cells' 8 rows of 2,048 steps and the granite cell's 2
# rows of 8,192, mamba2-1.3b's heads in both. Its gradients are held to the
# f64 twin at each call, at a quarter of the first's batch with a gradient of
# the final state, and at SSD_BWD_SMALL ((B, S, H, chunk, gh given) at P 64,
# N 128: the card tests' cases, S a multiple of every chunk or ragged):
# - dx, dBm, dCm case by case: as returned within SSD_BWD_FACTOR x the gap
#   of autograd of float32 ``ssd_chunked`` (no farther from f64 than the
#   path they replace, twice over for another summation order), the float32
#   sums within SSD_BWD_F32_TOL normwise (float32 round-off of sums of a
#   chunk's terms; the kernel's read 1.2e-7 to 4.1e-7 at the card tests'
#   cases) or SSD_BWD_F32_FACTOR x float32 ``ssd_chunked``'s own float32
#   gap, the larger: at the cells' call float32 ``ssd_chunked`` itself
#   reads up to 1.02e-6 (dBm), and the kernel's float32 sums 0.42 to 2.46 x
#   its gap (dx 1.70e-6 against 6.92e-7 on this row's inputs, 8.77e-7
#   against 5.69e-7 on another seed);
# - ddt and dA by the worst gap over all the cases, within SSD_BWD_FACTOR x
#   float32 ``ssd_chunked``'s worst: a case's gap of these sums over whole
#   sequences is float32 noise of either path (48 cases on the card: one in
#   seven had the kernel beyond 2 x ssd_chunked's gap, as many the other
#   way; the worst 5.0e-6 against 4.9e-6), so a rule per case would fail a
#   correct kernel on some seeds.
SSD_BWD_SHAPES = {"cells_step": (8, 2048, 64, 64, 128, 256),
                  "granite_step": (2, 8192, 64, 64, 128, 256)}
SSD_BWD_SMALL = [(2, S, 4, chunk, with_gh) for chunk in (64, 128, 256) for S in (1024, 600)
                 for with_gh in (True, False)]
SSD_BWD_FACTOR = 2.0
SSD_BWD_F32_TOL = 1e-6
SSD_BWD_F32_FACTOR = 4.0
# The mixer's conv + SiLU at the cells' calls (B, S, C, W): the mamba2 cells'
# 8 rows of 2,048 and the granite cell's 2 rows of 8,192, conv_dim 4,352
# (x, B, C of mamba2-1.3b's widths) read as the column slice [4096, 8448)
# of the (B, S, 8512) in-projection output. The forward is held bit for bit
# to the plain expression; the backward's dx, dw, db to the f64 twin
# ``causal_conv_silu_bwd_ref`` within CONV_BWD_FACTOR x the gap of autograd
# of the expression on the same bf16 inputs (the card tests' rule; the gap
# of float32 autograd from float32 leaves is printed beside it).
CONV_SHAPES = {"cells_step": (8, 2048, 4352, 4), "granite_step": (2, 8192, 4352, 4)}
CONV_IN_PROJ = (4096, 8512)  # where the slice starts, the in-projection's width
CONV_BWD_FACTOR = 2.0
# K4 against the exact answer (the sequential recurrence in f64 on the same
# input values) and against its f32 plain versions on the card (the
# sequential recurrence and the chunked form), normwise, for both input
# types: the kernel reads bf16 exactly and computes in f32, and every one
# of the three sums its decay segments directly, so each is within f32
# round-off of its own size of the exact answer. (Decay factors taken as
# differences of cumulative sums, the TPU kernel's form, were 2e-5 off at
# the training step: see PERF.md.)
SSD_EXACT_TOL = 1e-5
SSD_PLAIN_TOL = {"ssd_scan_ref": 1e-5, "ssd_chunked": 1e-5}
# mamba2-1.3b training, kernel path against plain path, same weights and
# batch: the loss (relative) and each parameter's gradient (max |kernel -
# plain| over max |plain|, worst parameter). In f32 both differ by f32
# round-off only. In bf16, K4's CUDA-core body (a forward that rounds as
# ``ssd_chunked`` does) against the plain path: a one-ulp difference in a
# layer's bf16-rounded SSD output (2^-8 relative) is carried through 48
# layers and the backward pass; 5e-2 is about a dozen bf16 ulps. (The
# tensor-core body rounds otherwise; the f64 witness holds it.) A wrong
# kernel moves the loss and gradients by their own size.
TRAIN_TOL = {
    "float32": {"loss": 1e-5, "grad": 1e-4},
    "bfloat16": {"loss": 1e-2, "grad": 5e-2},
}
# The witness rule of the bf16 training forward (ROADMAP Queue 3 item 1): a
# K4 body's gradients, against the plain path in float64 from the same
# bf16 weights, within this factor of the plain bf16 path's own gap to it,
# the 2 x spread idea of the bf16 LM checks, measured against the truth.
WITNESS_FACTOR = 2.0
# A served model's kernel path against its plain path on the card, in
# bf16, normwise over the logits and each cache tensor: one rounding
# difference in the attention or the scan output can move a bf16 value by
# one ulp (2^-8 relative) and the layers after it carry that on; 5e-2 is
# about a dozen ulps of the largest value. A wrong kernel (head mapping,
# mask, state) moves values by their own size.
SERVE_TOL = 5e-2
# The port on the card against the port on the CPU in f32, normwise: f32
# round-off in other summation orders (cuBLAS vs CPU, the kernels vs their
# plain versions), through at most 3 layers and 3 decode steps.
CARD_VS_CPU_TOL = 1e-4
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


def device_us(ev) -> float:
    """Self device time (µs) of a torch.profiler key-average entry."""
    dev_us = getattr(ev, "self_device_time_total", None)
    if dev_us is None:
        dev_us = getattr(ev, "self_cuda_time_total", 0.0)
    return dev_us


def profiled_device_times(fn, reps: int, *names: str):
    """Device time per call of ``fn`` by kernel name, from torch.profiler
    over ``reps`` calls: ({name: ms} for each of ``names`` (a kernel of
    several passes names each; a name matches every kernel whose name
    contains it), the ms of every kernel that ran). Raises if one of
    ``names`` saw no device time (a renamed kernel, or a profiler that sees
    no device time), rather than returning nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {n: 0.0 for n in names}
    every = 0.0
    for ev in prof.key_averages():
        if device_us(ev) <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        every += device_us(ev)
        for n in names:
            if n in ev.key:
                by_name[n] += device_us(ev)
    missing = [n for n, us in by_name.items() if not us]
    if missing:
        raise AssertionError(f"the profiler saw no device time of a kernel named {missing}")
    return {n: us / reps / 1e3 for n, us in by_name.items()}, every / reps / 1e3


def profiled_device_ms(fn, reps: int, *names: str) -> float:
    """Device time per call of ``fn``: the time of the kernels whose name
    contains one of ``names`` (a kernel with a body per dtype names each),
    from torch.profiler, over ``reps`` calls. Raises if no such kernel ran
    under the profiler (a renamed kernel, or a profiler that sees no device
    time), rather than returning nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(
        device_us(ev) for ev in prof.key_averages()
        if any(n in ev.key for n in names) and device_us(ev) > 0
    )
    if not total:
        raise AssertionError(
            f"the profiler saw no device time of a kernel named {names}"
        )
    return total / reps / 1e3


def pass_times(label: str, fn, reps: int, names) -> dict:
    """Per-pass device ms of a kernel of several launches (every one of
    ``names`` must run) and their sum as ``device_ms``. Raises unless the
    passes account for all the device time of the call (within 1%): a
    launch under another name would drop out of ``device_ms`` and make the
    share of the bound read high."""
    passes, every = profiled_device_times(fn, reps, *names)
    total = sum(passes.values())
    if abs(total - every) > 0.01 * every:
        raise AssertionError(
            f"{label}: the named passes {passes} sum to {total:.4f} ms, the call's "
            f"kernels to {every:.4f} ms"
        )
    return dict(passes=passes, device_ms=total, all_kernels_ms=every)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in f64, 2^26 elements at a time (a 1 B-element
    embedding's gradient would take 8 GB a copy in f64)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 26
    return max(
        (a[i:i + step].double() - b[i:i + step].double()).abs().max().item()
        for i in range(0, max(a.numel(), 1), step)
    )


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


def roofline(row: dict, nbytes: float, flops: float, peak_flops: float) -> dict:
    """Add to a kernel's row its bound (the benchmark's ``bound_s``: the
    larger of ``nbytes`` over the memory rate and ``flops`` over
    ``peak_flops``), what bounds it, its share of the bound (bound_ms /
    device_ms) and the rate it achieved: TFLOP/s where operations bound
    it, TB/s where bytes do."""
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / peak_flops
    row["bound_ms"] = bound_s(nbytes, flops, peak_flops) * 1e3
    row["bound_by"] = "bytes" if by_bytes else "operations"
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
    seconds = row["device_ms"] * 1e-3
    if by_bytes:
        row["achieved_rate"], row["rate_unit"] = nbytes / seconds / 1e12, "TB/s"
    else:
        row["achieved_rate"], row["rate_unit"] = flops / seconds / 1e12, "TFLOP/s"
    return row


def coded_work(kind, R, J, n, dtype, alive_rows):
    """(bytes, flops, peak flops) of one K1/K2 call on this call's data:
    each input read once, each output written once. Dead message rows need
    not be read (the kernel never loads them), so only the ``alive_rows``
    of the R * J count. 2 flops per alive message element (+6 per output
    for the update) at the accumulation type's peak rate."""
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
    return nbytes, flops, PEAK_FLOPS[ct]


def phase_analysis():
    """The AST lint of the port, then the step audit of every grid on the
    card in f64, gated against the committed pin."""
    from repro_torch.analysis import lint_paths, traceaudit

    t0 = time.perf_counter()
    findings = lint_paths([os.path.join(ROOT, "src", "repro_torch")], root=ROOT)
    for f in findings:
        log(f"[analysis] {f}")
    if findings:
        raise AssertionError(f"[analysis] {len(findings)} lint finding(s)")
    lint_s = time.perf_counter() - t0
    report = traceaudit.audit_report(device="cuda", dtype=torch.float64)
    for name, entry in report.items():
        sigs = list(entry["signatures"].values())
        log(
            f"[analysis] {name}: groups {entry['groups']}, k1_calls "
            f"{[c['k1_calls'] for c in sigs]}, k1_launches "
            f"{[c['k1_launches'] for c in sigs]}, host_syncs "
            f"{[c['host_syncs'] for c in sigs]}, demotions "
            f"{[c['demotions'] for c in sigs]}, out_dtypes "
            f"{sorted({d for c in sigs for d in c['out_dtypes']})}"
        )
    unchecked = [
        f"{name} {sig}" for name, entry in report.items()
        for sig, c in entry["signatures"].items()
        if c["host_syncs"] is None or c["k1_launches"] is None
    ]
    if unchecked:
        raise AssertionError(f"[analysis] no card reading for {unchecked}")
    baseline = traceaudit.load_baseline()
    if baseline is None:
        raise AssertionError("[analysis] no committed trace_audit.json")
    failures, notes = traceaudit.compare_report(report, baseline)
    for n in notes:
        log(f"[analysis] note: {n}")
    for f in failures:
        log(f"[analysis] FAIL: {f}")
    if failures:
        raise AssertionError(f"[analysis] {len(failures)} contract failure(s)")
    n_sigs = sum(len(e["signatures"]) for e in report.values())
    log(
        f"[analysis] lint clean in {lint_s:.2f} s; {len(report)} grids / "
        f"{n_sigs} groups clean against the pin; phase "
        f"{time.perf_counter() - t0:.2f} s"
    )


def phase_build():
    """Build every CUDA source at once, one nvcc process each."""
    from repro_torch.kernels import _build

    names = ("coded_combine", "flash_attention", "rglru_scan", "ssd_scan", "causal_conv")

    def timed(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(timed, names))
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.2f} s")
    for lib, seconds in built:
        log(f"[build] {lib.name} in {seconds:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")
    sass_check(built[names.index("ssd_scan")][0],
               ("ssd_scores_kernel", "ssd_scan_tc_kernel", "ssd_bwd_states_kernel",
                "ssd_bwd_dstates_kernel", "ssd_bwd_dx_kernel", "ssd_bwd_ds_kernel",
                "ssd_bwd_dbc_kernel"))
    sass_check(built[names.index("flash_attention")][0],
               ("flash_attention_tc_kernel", "flash_attention_bwd_tc_kernel"))
    from repro_torch.kernels.causal_conv import KERNEL_NAMES as CONV_KERNELS

    sass_check(built[names.index("causal_conv")][0], (),
               present=[n for names_ in CONV_KERNELS.values() for n in names_])


def sass_check(lib, tensor_core_kernels, present=()) -> dict:
    """Count the tensor-core instructions (HGMMA, wgmma's SASS) of every
    kernel in ``lib`` from ``cuobjdump -sass``; raise unless each of
    ``tensor_core_kernels`` holds some and each of ``present`` is there."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    log(f"[build] {lib.name} HGMMA instructions by kernel (cuobjdump -sass): "
        + json.dumps(counts))
    for name in tensor_core_kernels:
        if not any(name in fn and n > 0 for fn, n in counts.items()):
            raise AssertionError(f"{name}: no HGMMA in its SASS")
    for name in present:
        if not any(name in fn for fn in counts):
            raise AssertionError(f"{name}: not in the SASS of {lib.name}")
    return counts


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
                row = dict(
                    name=name, shape=shape_name, R=R, J=J, n=n,
                    dtype=str(dtype).replace("torch.", ""),
                    alive_rows=alive_rows, max_abs_err=err, tol=tol * scale,
                    ms=cuda_ms(kern, reps),
                    device_ms=profiled_device_ms(kern, reps, *K12_KERNELS),
                    plain_ms=cuda_ms(plain, reps),
                    library_ms=None if lib is None else cuda_ms(lib, reps),
                )
                roofline(row, *coded_work(name, R, J, n, dtype, alive_rows))
                log("[kernels] " + json.dumps(row))
                rows.append(row)
                hold(f"{name} {shape_name} {dtype}", out, want, tol)
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

    spec = get_sweep("fig5")
    counters = reset_launches()
    t0 = time.perf_counter()
    gpu = run_sweep(spec, device="cuda", dtype=torch.float64)
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
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

    spec = get_sweep("fig3_stragglers", runs=1)
    counters = reset_launches()
    t0 = time.perf_counter()
    gpu = run_sweep(spec, device="cuda", dtype=torch.float32)
    wall = time.perf_counter() - t0
    iters = gpu.cases[0].iters
    log(
        f"[fig3_stragglers] cuda f32: {len(gpu.cases)} runs x {iters} iters "
        f"in {gpu.n_dispatches} group(s), wall {wall:.3f} s, launches "
        f"{read_launches(counters)}"
    )
    if counters["coded_admm_update"] != iters * gpu.n_dispatches:
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


# The methods whose step runs K1 (the stochastic incremental-ADMM family);
# W-ADMM and the gossip methods (D-ADMM, DGD, EXTRA) never do.
K1_METHODS = ("sI-ADMM", "csI-ADMM", "pI-ADMM", "cq-sI-ADMM", "a-csI-ADMM")
# Card against CPU, both f64, normwise per run and field: fig5's bound.
SWEEP_TOL = 1e-9


def counted_sweep(spec, device):
    """`run_sweep` of ``spec`` on ``device`` in f64. Returns the result and
    one row per static group, in dispatch order: its method, runs,
    iterations, wall seconds and K1 launches, read around the sweep
    engine's per-group dispatch."""
    from repro_torch.experiments import run_sweep
    from repro_torch.experiments import sweep as engine
    from repro_torch.kernels._build import LAUNCHES

    rows = []
    dispatch = engine._dispatch_group

    def timed(method, cases, *args):
        before = LAUNCHES["coded_admm_update"]
        t0 = time.perf_counter()
        out = dispatch(method, cases, *args)  # traces copied to the host
        rows.append(dict(
            method=method, runs=len(cases), iters=cases[0].iters,
            wall_s=time.perf_counter() - t0,
            k1=LAUNCHES["coded_admm_update"] - before,
        ))
        return out

    engine._dispatch_group = timed
    try:
        result = run_sweep(spec, device=device, dtype=torch.float64)
    finally:
        engine._dispatch_group = dispatch
    return result, rows


def sweep_card_vs_cpu(label, name, **overrides):
    """Sweep ``name`` at its registry defaults (``overrides`` aside) on the
    card and on the CPU, both f64: the same grid and groups, the host
    clocks and communication counts bitwise, every run's traces within
    SWEEP_TOL; K1 launched ``iters`` times in each group of a K1 method
    and never in another, and no other kernel launched. Returns the card's
    result and its group rows."""
    from repro_torch.experiments import get_sweep

    spec = get_sweep(name, **overrides)
    counters = reset_launches()
    gpu, rows = counted_sweep(spec, "cuda")
    launches = read_launches(counters)
    for r in rows:
        want = r["iters"] if r["method"] in K1_METHODS else 0
        if r["k1"] != want:
            raise AssertionError(
                f"{name} group {r['method']} launched K1 {r['k1']} times, "
                f"want {want}"
            )
    k1 = sum(r["k1"] for r in rows)
    if launches != {**{k: 0 for k in launches}, "coded_admm_update": k1}:
        raise AssertionError(f"{name} launches {launches}, want K1 {k1} only")
    cpu, cpu_rows = counted_sweep(spec, "cpu")
    if gpu.groups != cpu.groups or [c.label() for c in gpu.cases] != [
        c.label() for c in cpu.cases
    ]:
        raise AssertionError(f"{name}: card and CPU grids differ")
    for case, a, b in zip(gpu.cases, gpu.traces, cpu.traces):
        for field in ("comm_cost", "sim_time"):
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"{name} {case.label()} {field} differs")
    worst = compare_traces(f"{label} {name}", gpu, cpu, rtol=SWEEP_TOL)
    n_k1 = sum(r["method"] in K1_METHODS for r in rows)
    log(
        f"[{label}] {name}: {len(gpu.cases)} runs in {gpu.n_dispatches} "
        f"group(s); card f64 wall {gpu.wall_s:.3f} s, CPU f64 wall "
        f"{cpu.wall_s:.3f} s; K1 launches {k1} ({n_k1} K1 group(s) x iters), "
        f"other kernels 0; card vs CPU worst normwise gap {worst:.3e} "
        f"(tolerance {SWEEP_TOL:.0e})"
    )
    for r, c in zip(rows, cpu_rows):
        log(
            f"[{label}] {name} group {r['method']} x{r['runs']} runs x "
            f"{r['iters']} iters: card {r['wall_s']:.3f} s "
            f"({1e3 * r['wall_s'] / r['iters']:.3f} ms/step), CPU "
            f"{c['wall_s']:.3f} s ({1e3 * c['wall_s'] / c['iters']:.3f} "
            f"ms/step), K1 launches {r['k1']}"
        )
    return gpu, rows


def profile_sweep(label, name, iters):
    """Device busy share and top kernels of sweep ``name`` at ``iters``
    iterations on the card (f64, registry runs), under torch.profiler."""
    from repro_torch.experiments import get_sweep, run_sweep

    spec = get_sweep(name, iters=iters)
    prof = profile_share(
        lambda: run_sweep(spec, device="cuda", dtype=torch.float64),
        named=K12_KERNELS,
    )
    log(f"[{label}] {name} profile at {iters} iters: " + json.dumps(prof))


def first_reach(trace, target):
    """(iteration, comm_cost, sim_time) where ``trace`` first reaches
    accuracy <= ``target`` (1-based), or None if it never does."""
    hit = np.flatnonzero(trace.accuracy <= target)
    if hit.size == 0:
        return None
    k = int(hit[0])
    return [k + 1, float(trace.comm_cost[k]), float(trace.sim_time[k])]


def phase_baselines():
    """The paper's comparison (Fig. 3(c)(d)(e), Fig. 4): sI-ADMM against
    W-ADMM, D-ADMM, DGD and EXTRA at registry size, card against CPU. The
    paper's communication claim is logged as a fact of the run: where each
    method first reaches accuracy 0.15, and its communication there."""
    for name in ("fig3_baselines", "fig4_baselines", "fig3e_runtime"):
        gpu, _ = sweep_card_vs_cpu("baselines", name)
        summary = {}
        for method in dict.fromkeys(c.method for c in gpu.cases):
            traces = [t for _, t in gpu.select(method=method)]
            summary[method] = dict(
                final_accuracy=float(np.mean([t.accuracy[-1] for t in traces])),
                first_at_0_15=[first_reach(t, 0.15) for t in traces],
            )
        log(
            f"[baselines] {name} per method (final accuracy, mean of seeds; "
            f"[iteration, comm_cost, sim_time] at first accuracy <= 0.15, "
            f"per seed): {json.dumps(summary)}"
        )
    profile_sweep("baselines", "fig3_baselines", 100)


def same_iterates(label, cases, got, want):
    """Raise unless two lists of traces have equal iterates, bit for bit."""
    for case, a, b in zip(cases, got, want, strict=True):
        for field in TRACE_FIELDS:
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"{label} {case.label()} {field} differs")


def phase_variants():
    """pI-ADMM's privacy grid and cq-sI-ADMM's compression grid at registry
    size, card against CPU; then, on the card, each variant's control arm
    against sI-ADMM bit for bit, in a batch of the same shape (pI-ADMM at
    sigma = 0, cq-sI-ADMM top-k at frac = 1)."""
    from repro_torch.experiments import run_sweep

    priv, _ = sweep_card_vs_cpu("variants", "privacy_grid")
    comp, _ = sweep_card_vs_cpu("variants", "compression_grid")
    card = dict(device="cuda", dtype=torch.float64)
    twins = run_sweep(
        [dataclasses.replace(c, method="sI-ADMM") for c in priv.cases], **card
    )
    zero = [j for j, c in enumerate(priv.cases) if c.sigma == 0.0]
    same_iterates(
        "pI-ADMM sigma=0 vs sI-ADMM", [priv.cases[j] for j in zero],
        [priv.traces[j] for j in zero], [twins.traces[j] for j in zero],
    )
    full = [
        dataclasses.replace(c, frac=1.0) for c in comp.cases if c.compressor == "topk"
    ]
    cq = run_sweep(full, **card)
    si = run_sweep([dataclasses.replace(c, method="sI-ADMM") for c in full], **card)
    same_iterates("cq-sI-ADMM top-k frac=1 vs sI-ADMM", full, cq.traces, si.traces)
    log(
        f"[variants] control arms on the card, bit for bit: pI-ADMM at "
        f"sigma = 0 equals sI-ADMM ({len(zero)} runs of a {len(priv.cases)}-run "
        f"batch), cq-sI-ADMM top-k at frac = 1 equals sI-ADMM ({len(full)} runs)"
    )
    for name, res, by in (("privacy_grid", priv, ("sigma", "S")),
                          ("compression_grid", comp, ("compressor", "bits", "frac", "connectivity"))):
        cells = {}
        for c, t in zip(res.cases, res.traces):
            key = c.label(*by)
            cells.setdefault(key, []).append((t.accuracy[-1], t.comm_cost[-1]))
        log(
            f"[variants] {name} final accuracy and comm_cost per cell (mean "
            f"of seeds): " + json.dumps({
                k: [float(np.mean([a for a, _ in v])), float(v[0][1])]
                for k, v in cells.items()
            })
        )


def phase_grids():
    """The beyond-paper ADMM grids at registry size, card against CPU."""
    for name in ("topology_grid", "hetero_grid", "code_frontier", "mesh_scale"):
        gpu, _ = sweep_card_vs_cpu("grids", name)
        log(
            f"[grids] {name}: final accuracy mean {np.mean([t.accuracy[-1] for t in gpu.traces]):.6f}, "
            f"final sim_time mean {np.mean([t.sim_time[-1] for t in gpu.traces]):.6f} s (simulated)"
        )
    profile_sweep("grids", "mesh_scale", 100)


# Summary-by-summary comparison of streamed sweeps: the keys whose value
# is a clock reading chosen by a metric crossing a target (time_to) or a
# histogram bin (quantiles) are discrete; every other summary is
# continuous, held normwise per key.
DISCRETE_SUMMARIES = ("/time_to", "/quantiles")
# A discrete summary may differ where the metric lies this close (relative)
# to a target or a bin edge.
EDGE_TOL = 1e-9


def meminfo_gb() -> dict:
    """MemTotal and MemAvailable of the host, GB (/proc/meminfo)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024 / 1e9
    return out


def current_rss_gb():
    """This process's resident set now, GB, from /proc/self/statm (None
    where the system does not give it)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):
        return None


class PeakRss:
    """The peak resident set of this process over a block, GB: sampled
    every 20 ms from /proc/self/statm by a thread, or, where that is not
    readable, the process's lifetime peak (``getrusage``). ``source``
    says which."""

    def __enter__(self):
        import threading

        self.peak, self._stop = current_rss_gb(), threading.Event()
        self.source = "sampled" if self.peak is not None else "process lifetime peak"
        if self.peak is not None:
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, current_rss_gb() or 0.0)

    def __exit__(self, *exc):
        self._stop.set()
        if self.source == "sampled":
            self._thread.join()
        else:
            import resource

            self.peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
        return False


def near_edge(values: np.ndarray, edges: np.ndarray) -> bool:
    """True if any of ``values`` lies within EDGE_TOL (relative) of any of
    ``edges``."""
    gap = np.abs(values[:, None] - edges[None, :])
    return bool((gap <= EDGE_TOL * np.maximum(np.abs(edges[None, :]), 1e-300)).any())


def compare_summaries(label, got, want, spec, traces=None, tol=SWEEP_TOL):
    """Hold a streamed sweep's summaries (dicts of (runs, ...) arrays)
    against a reference: continuous keys normwise within ``tol`` per key;
    discrete keys (time_to, quantiles) equal, except where the reference
    run's metric (from ``traces``, its materialized twin) lies within
    EDGE_TOL of a target or a histogram bin edge. Returns (worst gap,
    explained discrete differences); raises on any other difference."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(got)} vs {sorted(want)}")
    worst, explained = 0.0, 0
    bin_edges = spec.lo + np.arange(1, spec.bins) * (spec.hi - spec.lo) / spec.bins
    for key, b in want.items():
        a = got[key]
        if a.shape != b.shape:
            raise AssertionError(f"{label} {key}: shape {a.shape} vs {b.shape}")
        if key.endswith(DISCRETE_SUMMARIES):
            field = key.split("/")[0]
            edges = np.asarray(spec.targets if key.endswith("/time_to") else bin_edges)
            for r in np.flatnonzero((a != b).reshape(len(a), -1).any(axis=1)):
                metric = None if traces is None else getattr(traces[r], field)
                if metric is None or not near_edge(np.asarray(metric), edges):
                    raise AssertionError(
                        f"{label} {key} run {r}: {a[r]} vs {b[r]}, metric not "
                        f"within {EDGE_TOL:.0e} of a target or bin edge")
                explained += 1
            continue
        fin = np.isfinite(b)
        if not np.array_equal(np.isfinite(a), fin):
            raise AssertionError(f"{label} {key}: finite entries differ")
        if fin.any():
            scale = float(np.abs(b[fin]).max())
            gap = float(np.abs(a[fin] - b[fin]).max())
            worst = max(worst, gap / max(scale, 1e-300))
            if gap > tol * max(scale, 1e-300):
                raise AssertionError(
                    f"{label} {key}: gap {gap:.3e} beyond {tol:.0e} x {scale:.3e}")
    return worst, explained


def phase_fleet(runs=1000, cpu_runs=2):
    """`fleet_frontier` at registry size through `run_sweep` with its
    Reduction on the card (one static group); its first ``cpu_runs`` seeds
    (12 runs each) held against the same sweep on the CPU. Host prepare,
    the host-to-device copy and the step loop are timed apart, a 50-step
    copy of the loop is profiled for the device busy share, and the peak
    device memory and host RSS are read. Returns the card's K1 launches."""
    from repro_torch.experiments import get_sweep, run_sweep
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.methods import driver

    mem = meminfo_gb()
    need = 12 * runs * 1.89e6 * 1.4 / 1e9  # stacked f64 arrays + slack
    if need > 0.8 * mem["MemAvailable"]:
        fit = int(0.8 * mem["MemAvailable"] * 1e9 / (12 * 1.89e6 * 1.4))
        log(f"[fleet] CUT: runs {runs} -> {fit}: the host holds "
            f"{mem['MemAvailable']:.1f} GB free, {need:.1f} GB needed")
        runs = fit
    spec = get_sweep("fleet_frontier", runs=runs)
    times = dict(prepare_s=0.0, stack_s=0.0, to_device_s=0.0, loop_s=0.0)
    prof = {}
    wrapped = {n: getattr(driver, n)
               for n in ("_stack_batch", "_stack", "prepared_to_device", "run_steps")}

    def timed(name, key):
        def fn(*a, **k):
            t0 = time.perf_counter()
            out = wrapped[name](*a, **k)
            if key == "to_device_s":
                torch.cuda.synchronize()
            times[key] += time.perf_counter() - t0
            return out
        return fn

    def loop_with_profile(kernel, statics, consts, steps, reductions=None):
        # A 50-step copy of the loop on the same device tensors, profiled
        # (its K1 launches are taken back out of the count).
        before = LAUNCHES["coded_admm_update"]
        prof.update(profile_share(lambda: wrapped["run_steps"](
            kernel, dict(statics, iters=50), consts,
            tuple(s[:, :50] for s in steps), reductions), named=K12_KERNELS))
        LAUNCHES["coded_admm_update"] = before
        t0 = time.perf_counter()
        out = wrapped["run_steps"](kernel, statics, consts, steps, reductions)
        torch.cuda.synchronize()
        times["loop_s"] += time.perf_counter() - t0
        return out

    driver._stack_batch = timed("_stack_batch", "prepare_s")
    driver._stack = timed("_stack", "stack_s")
    driver.prepared_to_device = timed("prepared_to_device", "to_device_s")
    driver.run_steps = loop_with_profile
    torch.cuda.reset_peak_memory_stats()
    try:
        with PeakRss() as rss:
            counters = reset_launches()
            t0 = time.perf_counter()
            gpu = run_sweep(spec, device="cuda", dtype=torch.float64)
            wall = time.perf_counter() - t0
            launches = read_launches(counters)
    finally:
        for n, fn in wrapped.items():
            setattr(driver, n, fn)
    peak_dev = torch.cuda.max_memory_allocated() / 2**30
    R, iters = len(gpu.cases), gpu.cases[0].iters
    if gpu.n_dispatches != 1 or gpu.traces:
        raise AssertionError(f"fleet: {gpu.n_dispatches} groups, traces {len(gpu.traces)}")
    if launches != {**{k: 0 for k in launches}, "coded_admm_update": iters}:
        raise AssertionError(f"fleet launches {launches}, want K1 {iters} only")
    for key, v in gpu.reduced.items():
        if v.shape[0] != R or np.isnan(v).any():
            raise AssertionError(f"fleet {key}: shape {v.shape}, NaN {np.isnan(v).any()}")
    log(
        f"[fleet] cuda f64: {R} runs x {iters} iters in 1 group, wall {wall:.3f} s "
        f"(host prepare {times['prepare_s']:.3f} s, stacking {times['stack_s']:.3f} s, "
        f"host-to-device {times['to_device_s']:.3f} s, step loop {times['loop_s']:.3f} s, "
        f"the rest (problems, grouping, summaries to the host) "
        f"{wall - sum(times.values()):.3f} s; "
        f"{R * iters / wall:.4g} run-iterations/s end to end, "
        f"{R * iters / times['loop_s']:.4g} in the loop); K1 launches "
        f"{launches['coded_admm_update']}, other kernels 0; peak device memory "
        f"{peak_dev:.2f} GiB; host peak RSS {rss.peak:.2f} GB ({rss.source}); "
        f"host memory {mem['MemTotal']:.1f} GB, "
        f"{mem['MemAvailable']:.1f} GB available")
    busy = prof["device_busy_ms"] / 50 / (1e3 * times["loop_s"] / iters)
    log(f"[fleet] profile of a 50-step copy of the loop: device busy "
        f"{prof['device_busy_ms'] / 50:.4f} ms a step against {1e3 * times['loop_s'] / iters:.4f} "
        f"ms a step of the unprofiled loop: busy share {busy:.3f} of the loop "
        f"(under the profiler {prof['busy_share']:.3f}); " + json.dumps(prof))
    # The CPU reference: the first cpu_runs seeds, streamed, and their
    # materialized twins (to tell a flipped bin or target from a fault).
    cpu_spec = get_sweep("fleet_frontier", runs=cpu_runs)
    t0 = time.perf_counter()
    cpu = run_sweep(cpu_spec, device="cpu", dtype=torch.float64)
    cpu_wall = time.perf_counter() - t0
    twins = run_sweep(dataclasses.replace(cpu_spec, reductions=None), device="cpu",
                      dtype=torch.float64)
    index = {c: i for i, c in enumerate(gpu.cases)}
    rows = np.array([index[c] for c in cpu.cases])
    worst, explained = compare_summaries(
        "fleet", {k: v[rows] for k, v in gpu.reduced.items()}, cpu.reduced,
        spec.reductions, twins.traces)
    log(f"[fleet] card vs CPU on {len(rows)} runs ({cpu_runs} seeds; CPU wall "
        f"{cpu_wall:.3f} s): continuous summaries worst normwise gap {worst:.3e} "
        f"(tolerance {SWEEP_TOL:.0e}); discrete summaries off by a metric within "
        f"{EDGE_TOL:.0e} of a target or bin edge: {explained}")
    acc = gpu.reduced["accuracy/at_budget"]
    log("[fleet] accuracy at sim-time budgets (mean over runs) per response/scheme/S: "
        + json.dumps({
            f"{r}/{sc}/S={S}": [float(x) for x in acc[[
                i for i, c in enumerate(gpu.cases)
                if (c.response, c.scheme, c.S) == (r, sc, S)]].mean(axis=0)]
            for r in ("lognormal", "pareto") for sc in ("cyclic", "mds", "approx")
            for S in (1, 2)
        }))
    del gpu
    torch.cuda.empty_cache()
    return dict(launches=launches["coded_admm_update"], runs=R, iters=iters, wall_s=wall,
                loop_s=times["loop_s"], prepare_s=times["prepare_s"])


def shard_twins(kernel, args, chunks, D, device):
    """`run_batch`'s path run shard by shard: the runs of each of
    `run_sharded`'s shards (chunks of ``chunks`` runs over D devices, the
    last run repeated as padding) in a batch of that shard's shape, under
    the whole group's statics, on ``device``. cuBLAS may take another
    algorithm for another batch size, so this, not one batch of all the
    runs, is what the tier must equal bit for bit. Returns the traces."""
    from repro_torch.methods import driver

    preps, statics = driver._stack_batch(kernel, *args)
    twins, lo = [], 0
    for n in chunks:
        per = -(-n // D)
        for j in range(lo, lo + n, per):
            idx = list(range(j, min(j + per, lo + n)))
            idx += [idx[-1]] * (per - len(idx))  # the padding repeats the last run
            twins += driver._run_prepared(kernel, [preps[i] for i in idx], statics, device,
                                          torch.float64)[:min(per, lo + n - j)]
        lo += n
    return twins


def phase_sharded(runs=5, iters=300, budget_mb="40"):
    """The chunked sharded tier on the card, listed twice as two devices,
    under a budget that forces at least three chunks: a 60-run slice of
    `fleet_frontier` with its Reduction (the lazy per-chunk path) and
    without it (the Trace path), held against `run_batch` on the card —
    the Trace path bit for bit, the summaries at 1e-12."""
    from repro_torch.experiments import get_sweep
    from repro_torch.experiments import sweep as engine
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.methods import driver, get_kernel, run_batch, run_sharded

    spec = get_sweep("fleet_frontier", iters=iters, runs=runs)
    cases = spec.cases()
    kernel = get_kernel("csI-ADMM")
    nc, pc = {}, {}
    mats = [engine._materialize(c, nc, pc) for c in cases]
    args = ([m[1] for m in mats], [m[0] for m in mats],
            [kernel.config(c) for c in cases], iters)
    devs = ["cuda:0", "cuda:0"]
    chunks = []
    run_chunk = driver._run_chunk
    driver._run_chunk = lambda *a: chunks.append(a[2][0].shape[0]) or run_chunk(*a)
    old = os.environ.get("REPRO_SHARD_MEM_MB")
    os.environ["REPRO_SHARD_MEM_MB"] = budget_mb
    try:
        out = {}
        for label, red in (("reduced", spec.reductions), ("trace", None)):
            del chunks[:]
            before = LAUNCHES["coded_admm_update"]
            t0 = time.perf_counter()
            out[label] = run_sharded(kernel, *args, red, devices=devs, dtype=torch.float64)
            seconds = time.perf_counter() - t0
            k1 = LAUNCHES["coded_admm_update"] - before
            if len(chunks) < 3 or k1 != iters * len(devs) * len(chunks):
                raise AssertionError(f"sharded {label}: chunks {chunks}, K1 {k1}")
            if red is None:
                trace_chunks = list(chunks)
            log(f"[sharded] {label} path: {len(cases)} runs x {iters} iters over "
                f"{len(devs)} shards in {len(chunks)} chunks {chunks} "
                f"(REPRO_SHARD_MEM_MB={budget_mb}), wall {seconds:.3f} s, K1 launches "
                f"{k1} (iters x shards x chunks)")
    finally:
        driver._run_chunk = run_chunk
        if old is None:
            del os.environ["REPRO_SHARD_MEM_MB"]
        else:
            os.environ["REPRO_SHARD_MEM_MB"] = old
    card = dict(device="cuda", dtype=torch.float64)
    twins = shard_twins(kernel, args, trace_chunks, len(devs), torch.device("cuda"))
    same_iterates("sharded trace path vs run_batch per shard", cases, out["trace"], twins)
    for a, b in zip(out["trace"], twins):
        if not (np.array_equal(a.sim_time, b.sim_time) and np.array_equal(a.comm_cost, b.comm_cost)):
            raise AssertionError("sharded trace path: clocks differ")
    whole = compare_traces("sharded trace path vs one run_batch",
                           SimpleNamespace(cases=cases, traces=out["trace"]),
                           SimpleNamespace(traces=run_batch(kernel, *args, **card)),
                           rtol=1e-12, atol=0.0)
    red_batch = run_batch(kernel, *args, spec.reductions, **card)
    worst, explained = compare_summaries("sharded reduced", out["reduced"], red_batch,
                                         spec.reductions, tol=1e-12)
    if explained:
        raise AssertionError(f"sharded reduced: {explained} discrete summaries differ")
    log(f"[sharded] Trace path equals run_batch bit for bit in batches of the shards' "
        f"shape ({len(cases)} runs), and one run_batch of all {len(cases)} runs within "
        f"{whole:.3e} normwise (tolerance 1e-12); reduced path vs run_batch worst "
        f"normwise gap {worst:.3e} (tolerance 1e-12), discrete summaries equal")


def phase_multi_card():
    """The sharded tier across every card of the host (not part of
    ``main``, which needs one card; run it where there are several, e.g.
    ``PYTHONPATH=src python3 -c "import chip_smoke as c; c.phase_build();
    c.phase_multi_card()"``):
    `mesh_scale` and a 240-run `fleet_frontier` slice with ``mode="auto"``
    (sharded over every card) against ``mode="batched"`` (one card),
    alternating, with wall times and K1 launches; the Trace path bit for
    bit against its shard twins on card 0, and both paths normwise
    against the one-card batch."""
    from repro_torch.experiments import get_sweep, run_sweep
    from repro_torch.experiments import sweep as engine
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.methods import get_kernel

    D = torch.cuda.device_count()
    if D < 2:
        raise AssertionError(f"phase_multi_card needs several cards, found {D}")
    card = dict(device="cuda", dtype=torch.float64)
    for name, kw in (("mesh_scale", dict(iters=600)), ("fleet_frontier", dict(iters=300, runs=20))):
        spec = get_sweep(name, **kw)
        walls, out = {}, {}
        for mode in ("batched", "auto", "batched", "auto"):
            LAUNCHES["coded_admm_update"] = 0
            t0 = time.perf_counter()
            res = run_sweep(spec, mode=mode, **card)
            walls.setdefault(res.mode, []).append(time.perf_counter() - t0)
            out[res.mode] = res
            log(f"[multi-card] {name} mode {mode} -> {res.mode} on {res.n_devices} card(s): "
                f"{len(res.cases)} runs, wall {walls[res.mode][-1]:.3f} s, K1 launches "
                f"{LAUNCHES['coded_admm_update']}")
        sharded, batched = out["sharded"], out["batched"]
        if sharded.n_devices != D:
            raise AssertionError(f"{name}: sharded over {sharded.n_devices} of {D} cards")
        if sharded.reduced is not None:
            worst, explained = compare_summaries(name, sharded.reduced, batched.reduced,
                                                 spec.reductions, tol=1e-12)
            if explained:
                raise AssertionError(f"{name}: {explained} discrete summaries differ")
            detail = f"summaries within {worst:.3e} of one card's (tolerance 1e-12)"
        else:
            worst = compare_traces(name, sharded, batched, rtol=1e-12, atol=0.0)
            kernel, cases = get_kernel(spec.base.method), sharded.cases
            nc, pc = {}, {}
            mats = [engine._materialize(c, nc, pc) for c in cases]
            args = ([m[1] for m in mats], [m[0] for m in mats],
                    [kernel.config(c) for c in cases], cases[0].iters)
            twins = shard_twins(kernel, args, [len(cases)], D, torch.device("cuda", 0))
            same_iterates(f"{name} shards vs twins", cases, sharded.traces, twins)
            detail = (f"traces bit for bit their shard twins on card 0, within {worst:.3e} of "
                      f"one card's batch (tolerance 1e-12)")
        log(f"[multi-card] {name} over {D} cards: {detail}; walls "
            + json.dumps({k: [round(x, 3) for x in v] for k, v in walls.items()}))


def phase_multi_card_consensus(devices=None, steps=3, seq=1024):
    """The consensus agent axis across cards (not part of ``main``, which
    needs one card; run it where there are four, e.g. ``PYTHONPATH=src
    python3 -c "import chip_smoke as c; c.phase_build();
    c.phase_multi_card_consensus()"``): consensus-qwen3 at full width and
    depth with A = 4 agents (K 4, S 1, cyclic, one row a partition: 32
    rows of ``seq`` tokens a step), ``steps`` incremental steps and one
    parallel step, one agent a card (``ConsensusRuntime(devices=...)``,
    ``devices`` the first four cards by default) against the same run with
    every agent on card 0, from the same weights, batches and stragglers.
    The two runs' losses are held at TRAIN_TOL's loss level of their dtype;
    z (the worst leaf, normwise) in f32 (the model widened) at TRAIN_TOL's
    gradient level, in bf16 within 2 x the spread between card 0's bf16
    and f32 runs (the losses' spread printed beside it). Prints each run's
    step seconds, residuals and each card's peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ConsensusConfig, ConsensusRuntime
    from repro_torch.launch import train
    from repro_torch.models import get_model

    if devices is None:
        if torch.cuda.device_count() < 4:
            raise AssertionError(f"phase_multi_card_consensus needs four cards, found "
                                 f"{torch.cuda.device_count()}")
        devices = [f"cuda:{d}" for d in range(4)]
    devices = [torch.device(d) for d in devices]
    cards = sorted({d.index for d in devices})
    A = len(devices)
    label = "multi-card consensus-qwen3"
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), remat="full")
    model = get_model(cfg, device=devices[0],
                      generator=torch.Generator(devices[0]).manual_seed(0))
    ccfg = ConsensusConfig(n_agents=A, K=4, S=1, scheme="cyclic", rho=1.0, c_tau=20.0,
                           c_gamma=0.1, seed=0)
    args = consensus_args(agents=A, batch=A * 4 * 2, seq=seq, steps=steps + 1)
    batches = list(train.consensus_batches(args, ccfg.code(), cfg.vocab, cfg))
    log(f"[{label}] {cfg.name} at full size, A {A}, K 4, S 1, cyclic, {A * 8} rows of {seq} "
        f"tokens a step, {steps} incremental steps and 1 parallel; agents on "
        f"{[str(d) for d in devices]} against all on {devices[0]}")
    dtypes = param_dtypes(model)
    # Every run starts from these weights (a run leaves an agent's x in
    # the model, its workspace).
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            model.to(torch.float32)  # every weight; exact from bf16
        for placement, devs in (("card 0", None), ("across", devices)):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(w0[n])
            rt = ConsensusRuntime(model, ccfg, devices=devs)
            state = rt.init_state()
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            losses, residuals, step_s = [], [], []
            for k, (batch, alive) in enumerate(batches):
                # The runtime reads its mode at every step: the last is parallel.
                rt.cfg = dataclasses.replace(ccfg, mode="incremental" if k < steps else "parallel")
                tb = {key: torch.from_numpy(v).to(devices[0]) for key, v in batch.items()}
                for c in cards:
                    torch.cuda.synchronize(c)
                t0 = time.perf_counter()
                state, metrics = rt.train_step(state, tb, alive)
                losses.append(float(metrics["loss"]))
                residuals.append(float(metrics["consensus_residual"]))
                for c in cards:
                    torch.cuda.synchronize(c)
                step_s.append(time.perf_counter() - t0)
            peaks = {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 2**30 for c in cards}
            if not (np.isfinite(losses).all() and np.isfinite(residuals).all()):
                raise AssertionError(f"{label} {dtype} {placement}: losses {losses}")
            log(f"[{label}] {dtype}, agents {placement}: losses {json.dumps(losses)}, residuals "
                f"{json.dumps(residuals)}, step s {json.dumps(step_s)} (the last parallel), peak "
                f"GiB by card {json.dumps(peaks)}")
            runs[(dtype, placement)] = dict(
                losses=losses, residuals=residuals, step_s=step_s, peak_gib=peaks,
                z={n: t.cpu() for n, t in state["z"].items()})
            del rt, state, tb, metrics
            for c in cards:
                with torch.cuda.device(c):
                    torch.cuda.empty_cache()
    restore_dtypes(model, dtypes)
    del model, w0

    def z_gap(a, b):
        return max((normwise_gap(runs[a]["z"][n], runs[b]["z"][n]), n) for n in runs[b]["z"])

    def loss_gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(runs[a]["losses"], runs[b]["losses"]))

    f32, b16 = ("float32", "across"), ("bfloat16", "across")
    gaps = {"float32": (loss_gap(f32, ("float32", "card 0")), z_gap(f32, ("float32", "card 0"))),
            "bfloat16": (loss_gap(b16, ("bfloat16", "card 0")),
                         z_gap(b16, ("bfloat16", "card 0")))}
    spread = (loss_gap(("bfloat16", "card 0"), ("float32", "card 0")),
              z_gap(("bfloat16", "card 0"), ("float32", "card 0")))
    bounds = {"float32": (TRAIN_TOL["float32"]["loss"], TRAIN_TOL["float32"]["grad"]),
              "bfloat16": (TRAIN_TOL["bfloat16"]["loss"], 2 * spread[1][0])}
    for dtype, (lg, (zg, at)) in gaps.items():
        lb, zb = bounds[dtype]
        log(f"[{label}] {dtype}, agents across cards vs on card 0: losses relative gap {lg:.3e} "
            f"(bound {lb:.3e}), z worst leaf normwise {zg:.3e} at {at} (bound {zb:.3e})"
            + (f"; spread bf16 vs f32 on card 0: losses {spread[0]:.3e}, z {spread[1][0]:.3e} "
               f"at {spread[1][1]}" if dtype == "bfloat16" else ""))
        if lg > lb or zg > zb:
            raise AssertionError(f"{label} {dtype}: across cards vs card 0 beyond the bound")
    result = {f"{d}/{p}": {k: v for k, v in r.items() if k != "z"} for (d, p), r in runs.items()}
    result["gaps"] = {d: dict(loss=lg, z=zg) for d, (lg, (zg, _)) in gaps.items()}
    return result


def phase_async():
    """`staleness_frontier` and `churn_grid` at registry size, card against
    CPU; then on the card each sync arm (tau_max = 0, churn_rate = 0) bit for
    bit against the same cases run as a sync-only sweep (a batch of the same
    shape)."""
    from repro_torch.experiments import run_sweep

    card = dict(device="cuda", dtype=torch.float64)
    for name, sync_field, groups in (("staleness_frontier", "tau_max", 8),
                                     ("churn_grid", "churn_rate", 2)):
        gpu, rows = sweep_card_vs_cpu("async", name)
        if gpu.n_dispatches != groups:
            raise AssertionError(f"{name}: {gpu.n_dispatches} groups, want {groups}")
        sync = [j for j, c in enumerate(gpu.cases) if getattr(c, sync_field) == 0.0]
        twins = run_sweep([gpu.cases[j] for j in sync], **card)
        same_iterates(f"{name} sync arm vs sync-only twin", [gpu.cases[j] for j in sync],
                      [gpu.traces[j] for j in sync], twins.traces)
        cells = {}
        for c, t in zip(gpu.cases, gpu.traces):
            key = c.label("method", sync_field) if name == "staleness_frontier" else c.label(
                "scheme", sync_field)
            cells.setdefault(key, []).append(float(t.accuracy[-1]))
        log(f"[async] {name}: {gpu.n_dispatches} groups; sync arm equals its sync-only "
            f"twin bit for bit ({len(sync)} runs); final accuracy per cell (mean of "
            f"seeds): " + json.dumps({k: float(np.mean(v)) for k, v in cells.items()}))


def phase_adaptive():
    """`adaptive_frontier` at registry size, card against CPU; then on the
    card `device_pulls` against the host `replay` for both algorithms
    (exactly), and a single-arm controller against the static csI-ADMM run
    bit for bit."""
    from repro_torch.control import ADAPTIVE_KERNEL, device_pulls
    from repro_torch.experiments import get_sweep, run_sweep
    from repro_torch.experiments import sweep as engine

    gpu, _ = sweep_card_vs_cpu("adaptive", "adaptive_frontier")
    spec = get_sweep("adaptive_frontier")
    for algo in ("ucb1", "exp3"):
        case = [c for c in spec.cases() if c.bandit == algo][0]
        net, prob = engine._materialize(case, {}, {})
        run = ADAPTIVE_KERNEL.config(case)
        t0 = time.perf_counter()
        dev = device_pulls(prob, net, run, case.iters, device="cuda")
        seconds = time.perf_counter() - t0
        host = ADAPTIVE_KERNEL._arm_tables(prob, net, run, case.iters)["pulls"]
        flips = np.flatnonzero(dev != host)
        if flips.size:
            raise AssertionError(f"device_pulls {algo}: the card flips arms at iterations "
                                 f"{flips[:10].tolist()} of {case.iters}")
        log(f"[adaptive] device_pulls {algo} on the card equals replay over {case.iters} "
            f"iterations ({seconds:.3f} s); pulls per arm {np.bincount(dev, minlength=len(run.arms)).tolist()}")
    card = dict(device="cuda", dtype=torch.float64)
    base = [c for c in spec.cases() if c.bandit == "ucb1"][0]
    for scheme, S, deadline in base.arms[::2]:
        one = dataclasses.replace(base, arms=((scheme, S, deadline),))
        static = dataclasses.replace(one, method="csI-ADMM", scheme=scheme, S=S,
                                     deadline=deadline, arms=())
        res = run_sweep([one, static], **card)
        same_iterates(f"single arm {scheme} S={S} vs csI-ADMM", [one], res.traces[:1],
                      res.traces[1:])
    log(f"[adaptive] single-arm controllers equal the static csI-ADMM run bit for bit "
        f"on the card ({len(base.arms[::2])} arms); final accuracy per bandit (mean of "
        f"seeds): " + json.dumps({a: float(np.mean([t.accuracy[-1] for c, t in gpu.select(bandit=a)]))
                                  for a in ("ucb1", "exp3")}))


def normwise_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(max |want|, 1)."""
    scale = max(float(want.abs().max().item()), 1.0)
    return max_err(got, want) / scale


def hold(label: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Raise unless ``got`` has ``want``'s shape and dtype, is finite and
    lies within ``tol`` of it normwise; returns the gap."""
    got, want = got.detach(), want.detach()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}"
        )
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    gap = normwise_gap(got, want.to(got.device))
    if gap > tol:
        raise AssertionError(f"{label}: normwise gap {gap:.3e} > {tol:.0e}")
    return gap


def hold_cache(label: str, got: dict, want: dict, tol: float) -> float:
    if set(got) != set(want) or got["len"] != want["len"]:
        raise AssertionError(f"{label}: cache keys/len {sorted(got)} {got['len']} "
                             f"vs {sorted(want)} {want['len']}")
    return max(
        hold(f"{label} cache[{k}]", got[k], want[k].to(got[k].device), tol)
        for k in got if k != "len"
    )


def attention_call(B, S, H, KV, hd, window, dtype) -> dict:
    """A K3 call as `portbench.work.flash_attention` reads it: q (B, S, H,
    hd), k (B, S, KV, hd), ``window``, the inputs' dtype."""
    return dict(shapes=[(B, S, H, hd), (B, S, KV, hd)], kwargs=dict(window=window),
                dtypes=[dtype])


def phase_attention_kernels():
    """K3 against its plain version (and SDPA's time) at every shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    rows = []
    for shape_name, (B, S, H, KV, hd, window, dtype) in ATTN_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(S * hd + H)
        q, k, v = (
            torch.randn(B, S, n, hd, generator=g, device="cuda").to(dtype)
            for n in (H, KV, KV)
        )
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def kern():
            return flash_attention_kernel(q, k, v, causal=True, window=window)

        def plain():
            return ref.flash_attention_ref(qt, kt, vt, causal=True, window=window)

        if window is None:
            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device="cuda")
            band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

        out = kern()
        want = plain().transpose(1, 2)
        torch.cuda.synchronize()
        reps = 5
        row = dict(
            name="flash_attention", shape=shape_name, B=B, S=S, H=H, KV=KV, hd=hd,
            window=window, dtype=str(dtype).replace("torch.", ""),
            max_abs_err=max_err(out, want), normwise_err=normwise_gap(out, want),
            tol=ATTN_TOL[dtype],
            ms=cuda_ms(kern, reps),
            device_ms=profiled_device_ms(kern, reps, *K3_KERNELS),
            plain_ms=cuda_ms(plain, 2),
            library_ms=cuda_ms(library, reps),
        )
        roofline(row, *attention_work.forward(attention_call(B, S, H, KV, hd, window, dtype)))
        log("[kernels] " + json.dumps(row))
        rows.append(row)
        hold(f"flash_attention {shape_name}", out, want, ATTN_TOL[dtype])
        del q, k, v, qt, kt, vt, out, want
        torch.cuda.empty_cache()
    return rows


def phase_attention_scan():
    """K3 in bf16 against SDPA over the sequence length at a fixed 8192
    tokens (qwen3-0.6b's heads: H 16, KV 8, hd 128), causal and not: the
    ratio of the two rates says whether K3 loses per tile or per CTA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_kernel

    H, KV, hd = 16, 8, 128
    for causal in (True, False):
        for B, S in ((16, 512), (8, 1024), (4, 2048), (2, 4096), (1, 8192)):
            g = torch.Generator(device="cuda").manual_seed(S)
            q, k, v = (
                torch.randn(B, S, n, hd, generator=g, device="cuda").to(torch.bfloat16)
                for n in (H, KV, KV)
            )
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            out = flash_attention_kernel(q, k, v, causal=causal)
            want = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)
            hold(f"attention scan S {S} causal {causal}", out, want, ATTN_TOL[torch.bfloat16])
            t_k3 = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=causal), 20)
            t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
            flops = 4 * hd * (attention_work.live_pairs(S, S, None) if causal else S * S) * B * H
            log("[attention-scan] " + json.dumps(dict(
                causal=causal, B=B, S=S, ms=t_k3, library_ms=t_lib,
                tflops=flops / t_k3 / 1e9, library_tflops=flops / t_lib / 1e9,
                ratio=t_lib / t_k3)))


def phase_scan_kernels():
    """K5 against its plain version at every shape (no single PyTorch call
    computes the recurrence, so no library time)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel

    rows = []
    for shape_name, (B, S, W, with_h0) in SCAN_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(S + W)
        a = torch.rand(B, S, W, generator=g, device="cuda") * 0.8 + 0.2
        b = torch.randn(B, S, W, generator=g, device="cuda")
        h0 = torch.randn(B, W, generator=g, device="cuda") if with_h0 else None

        def kern():
            return rglru_scan_kernel(a, b, h0)

        def plain():
            return ref.rglru_scan_ref(a, b, h0)

        (h, h_last), (want_h, want_last) = kern(), plain()
        torch.cuda.synchronize()
        nbytes = (3 * B * S * W + (2 if with_h0 else 1) * B * W) * 4
        times = pass_times(f"rglru_scan {shape_name}", kern, 20, K5_KERNELS)
        row = dict(
            name="rglru_scan", shape=shape_name, B=B, S=S, W=W, h0=with_h0,
            dtype="float32", max_abs_err=max(max_err(h, want_h), max_err(h_last, want_last)),
            normwise_err=normwise_gap(h, want_h), tol=SCAN_TOL,
            ms=cuda_ms(kern, 20), device_ms=times["device_ms"], passes=times["passes"],
            plain_ms=cuda_ms(plain, 2), library_ms=None,
        )
        roofline(row, nbytes, 2 * B * S * W, PEAK_FLOPS[torch.float32])
        log("[kernels] " + json.dumps(row))
        rows.append(row)
        hold(f"rglru_scan {shape_name} h", h, want_h, SCAN_TOL)
        hold(f"rglru_scan {shape_name} h_last", h_last, want_last, SCAN_TOL)
        del a, b, h0, h, want_h
        torch.cuda.empty_cache()
    return rows


def phase_backward_kernels():
    """The K3 and K5 backward kernels against their plain twins at the
    training shapes, with device time, bound and (K3) the backward of
    SDPA at the same shape as the library yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        bwd_plan,
        flash_attention_bwd_kernel,
        flash_attention_kernel,
    )
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_kernel, rglru_scan_kernel

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape_name, (B, S, H, KV, hd, window, dtype) in ATTN_BWD_SHAPES.items():
        plan = bwd_plan(dtype, B, KV, H // KV, S, hd, sms)
        g = torch.Generator(device="cuda").manual_seed(S * hd + H + 1)
        q, k, v = (
            torch.randn(B, S, n, hd, generator=g, device="cuda").to(dtype)
            for n in (H, KV, KV)
        )
        do = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
        with torch.no_grad():
            o, lse = flash_attention_kernel(q, k, v, causal=True, window=window,
                                            return_lse=True)
        qt, kt, vt, ot, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, o, do))

        def kern():
            return flash_attention_bwd_kernel(q, k, v, o, do, lse, causal=True, window=window)

        # one row of the batch at a time where the whole batch's score
        # tensors would not fit beside the rest (ATTN_BWD_PLAIN_BYTES)
        rows_at_once = B if B * H * S * S * 4 <= ATTN_BWD_PLAIN_BYTES else 1

        def plain():
            parts = [ref.flash_attention_bwd_ref(*(t[b:b + rows_at_once] for t in
                                                   (qt, kt, vt, ot, dot, lse)), True, window)
                     for b in range(0, B, rows_at_once)]
            return tuple(torch.cat(g, 0) for g in zip(*parts))

        lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (qt, kt, vt))
        if window is None:
            lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device="cuda")
            band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
            lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=band, enable_gqa=True)

        def library():
            return torch.autograd.grad(lout, (lq, lk, lv), dot, retain_graph=True)

        got = kern()
        want = [w.transpose(1, 2) for w in plain()]
        torch.cuda.synchronize()
        passes = (K3_BWD_KERNELS[0], plan.body, K3_BWD_KERNELS[-1])
        times = pass_times(f"flash_attention_bwd {shape_name}", kern, 3, passes)
        row = dict(
            name="flash_attention_bwd", shape=shape_name, B=B, S=S, H=H, KV=KV, hd=hd,
            window=window, dtype=str(dtype).replace("torch.", ""), body=plan.body,
            keys_per_block=plan.keys, head_split=plan.split, blocks=plan.blocks,
            max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
            normwise_err={n: normwise_gap(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)},
            tol=ATTN_BWD_TOL[dtype], ms=cuda_ms(kern, 3), device_ms=times["device_ms"],
            passes=times["passes"], plain_ms=cuda_ms(plain, 1), library_ms=cuda_ms(library, 3),
        )
        roofline(row, *attention_work.backward(attention_call(B, S, H, KV, hd, window, dtype)))
        log("[kernels] " + json.dumps(row))
        rows.append(row)
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            hold(f"flash_attention_bwd {shape_name} {n}", a, b, ATTN_BWD_TOL[dtype])
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot, lq, lk, lv, lout, got, want
        torch.cuda.empty_cache()

    for shape_name, (B, S, W) in SCAN_BWD_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(S + W + 1)
        a = torch.rand(B, S, W, generator=g, device="cuda") * 0.8 + 0.2
        b = torch.randn(B, S, W, generator=g, device="cuda")
        h0 = torch.randn(B, W, generator=g, device="cuda")
        dh = torch.randn(B, S, W, generator=g, device="cuda")
        dl = torch.randn(B, W, generator=g, device="cuda")
        with torch.no_grad():
            h, _ = rglru_scan_kernel(a, b, h0)

        def kern():
            return rglru_scan_bwd_kernel(a, h, h0, dh, dl)

        def plain():
            return ref.rglru_scan_bwd_ref(a, h, h0, dh, dl)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        times = pass_times(f"rglru_scan_bwd {shape_name}", kern, 20, K5_BWD_KERNELS)
        row = dict(
            name="rglru_scan_bwd", shape=shape_name, B=B, S=S, W=W, dtype="float32",
            max_abs_err=max(max_err(x, y) for x, y in zip(got, want)),
            normwise_err={n: normwise_gap(x, y) for n, x, y in zip(("da", "db", "dh0"), got, want)},
            tol=SCAN_BWD_TOL, ms=cuda_ms(kern, 20), device_ms=times["device_ms"],
            passes=times["passes"], plain_ms=cuda_ms(plain, 1), library_ms=None,
        )
        # a, h, dh read and da, db written (20 bytes an element), h0, dh_last
        # read and dh0 written; 3 flops an element.
        roofline(row, (5 * B * S * W + 3 * B * W) * 4, 3 * B * S * W, PEAK_FLOPS[torch.float32])
        log("[kernels] " + json.dumps(row))
        rows.append(row)
        for n, x, y in zip(("da", "db", "dh0"), got, want):
            hold(f"rglru_scan_bwd {shape_name} {n}", x, y, SCAN_BWD_TOL)
        del a, b, h0, dh, dl, h, got, want
        torch.cuda.empty_cache()
    return rows


def ssd_call(B, S, H, P, N, chunk, dtype) -> dict:
    """A K4 call as `portbench.work.ssd_scan` reads it: x (B, S, H, P), dt
    (B, S, H), A (H,), Bm and Cm (B, S, N), ``chunk``, x's dtype."""
    return dict(shapes=[(B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N)],
                kwargs=dict(chunk=chunk), dtypes=[dtype])


def phase_ssd_kernels():
    """K4 against the exact answer and its plain versions at every shape
    (no single PyTorch call computes the scan, so no library time)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import KERNEL_NAMES, ssd_scan_kernel, ssd_scan_tc_kernel
    from repro_torch.models.mamba2 import ssd_chunked

    wrapper = {"cuda_cores": ssd_scan_kernel, "tensor_cores": ssd_scan_tc_kernel}

    rows = []
    for shape_name, (B, S, H, P, N, chunk, dtype, kbody) in SSD_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(S * H + P)
        x = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
        dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
        A = -torch.exp(torch.randn(H, generator=g, device="cuda"))
        if shape_name in SSD_A16:
            A[0] = -16.0
        Bm, Cm = (
            (torch.randn(B, S, N, generator=g, device="cuda") / N**0.5).to(dtype)
            for _ in range(2)
        )

        def kern():
            return wrapper[kbody](x, dt, A, Bm, Cm, chunk)

        def plain():
            return ref.ssd_scan_ref(x, dt, A, Bm, Cm)

        def chunked():
            return ssd_chunked(x, dt, A, Bm, Cm, chunk)

        with torch.no_grad():
            y, h = kern()
            exact = ref.ssd_scan_ref(*(t.double() for t in (x, dt, A, Bm, Cm)))
            versus = {"ssd_scan_ref": plain(), "ssd_chunked": chunked()}
            torch.cuda.synchronize()
            gaps = {"exact_f64": max(normwise_gap(y, exact[0]), normwise_gap(h, exact[1]))}
            if shape_name in SSD_A16:  # the A = -16 head alone
                gaps["exact_f64_head0"] = max(normwise_gap(y[:, :, 0], exact[0][:, :, 0]),
                                              normwise_gap(h[:, 0], exact[1][:, 0]))
            for name, (wy, wh) in versus.items():
                gaps[name] = max(normwise_gap(y, wy), normwise_gap(h, wh))
            times = pass_times(f"ssd_scan {shape_name}", kern, 10, KERNEL_NAMES[kbody])
            row = dict(
                name="ssd_scan", shape=shape_name, B=B, S=S, H=H, P=P, N=N, chunk=chunk,
                dtype=str(dtype).replace("torch.", ""), body=kbody,
                A_min=A.min().item(),
                max_abs_err=max(max_err(y, versus["ssd_scan_ref"][0]),
                                max_err(h, versus["ssd_scan_ref"][1])),
                normwise_err=gaps, tol=dict(SSD_PLAIN_TOL, exact_f64=SSD_EXACT_TOL),
                ms=cuda_ms(kern, 10), device_ms=times["device_ms"],
                plain_ms=cuda_ms(plain, 1), chunked_ms=cuda_ms(chunked, 3),
                library_ms=None,
            )
        roofline(row, *ssd_work.forward(ssd_call(B, S, H, P, N, chunk, dtype)))
        log("[kernels] " + json.dumps(row))
        log("[kernels] ssd_scan passes " + json.dumps(dict(
            shape=shape_name, body=kbody, device_ms=times["device_ms"],
            all_kernels_ms=times["all_kernels_ms"], passes=times["passes"])))
        rows.append(row)
        for label, (wy, wh), tol in (
            ("exact f64", exact, SSD_EXACT_TOL),
            *((n, versus[n], SSD_PLAIN_TOL[n]) for n in versus),
        ):
            hold(f"ssd_scan {shape_name} y vs {label}", y, wy.to(y.dtype), tol)
            hold(f"ssd_scan {shape_name} h_fin vs {label}", h, wh.to(h.dtype), tol)
        if shape_name in SSD_A16:
            hold(f"ssd_scan {shape_name} head 0 (A = -16) y vs exact f64",
                 y[:, :, 0], exact[0][:, :, 0].to(y.dtype), SSD_EXACT_TOL)
        del x, dt, A, Bm, Cm, y, h, exact, versus
        torch.cuda.empty_cache()
    rows += ssd_bwd_rows()
    return rows


def ssd_bwd_rows():
    """K4's backward kernel at the benchmark cells' calls (SSD_BWD_SHAPES,
    bf16, no gradient of the final state, head 0 at A = -16), a row each:
    its device time beside its bound and the plain backward's time
    (autograd of ``ssd_chunked`` on the same inputs, the path outside the
    tensor-core domain), and its five gradients against the f64 twin
    ``ssd_scan_bwd_ref`` on that call's own outputs. Besides the timed
    calls, the same check at the first call's heads with a gradient of the
    final state (a quarter of its batch) and at SSD_BWD_SMALL (module
    note): dx, dBm and dCm case by case, as returned (bf16) within
    SSD_BWD_FACTOR x the gap of autograd of float32 ``ssd_chunked`` and as
    the kernel's float32 sums (``grad_dtype`` float32) within
    SSD_BWD_F32_TOL or SSD_BWD_F32_FACTOR x that autograd's float32 gap;
    ddt and dA by the worst gap over all the cases. ``max_abs_err`` is the
    timed call's largest gap to the plain backward's gradients."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import KERNEL_NAMES, ssd_scan_bwd_tc_kernel
    from repro_torch.models.mamba2 import ssd_chunked

    B, S, H, P, N, chunk = SSD_BWD_SHAPES["cells_step"]
    names = ("dx", "ddt", "dA", "dBm", "dCm")

    def inputs(batch, S, H, with_gh, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(batch, S, H, P, generator=g, device="cuda").to(torch.bfloat16)
        dt = torch.nn.functional.softplus(torch.randn(batch, S, H, generator=g, device="cuda"))
        A = -torch.exp(torch.randn(H, generator=g, device="cuda"))
        A[0] = -16.0
        Bm, Cm = ((torch.randn(batch, S, N, generator=g, device="cuda") / N**0.5)
                  .to(torch.bfloat16) for _ in range(2))
        gy = torch.randn(batch, S, H, P, generator=g, device="cuda")
        gh = torch.randn(batch, H, P, N, generator=g, device="cuda") if with_gh else None
        return x, dt, A, Bm, Cm, gy, gh

    def chunked(x, dt, A, Bm, Cm, gy, gh, chunk, dtype=None):
        leaves = [(t if dtype is None else t.to(dtype)).detach().requires_grad_(True)
                  for t in (x, dt, A, Bm, Cm)]
        y, h = ssd_chunked(*leaves, chunk)
        outs = [(y, gy)] + ([(h, gh)] if gh is not None else [])
        return torch.autograd.grad([o for o, _ in outs], leaves, [g for _, g in outs])

    def rel(got, want):
        return max_err(got, want) / max(want.abs().max().item(), 1e-30)

    worst = {n: dict(kernel=0.0, ssd_chunked=0.0) for n in ("ddt", "dA")}

    def check(label, x, dt, A, Bm, Cm, gy, gh, chunk):
        """Gaps of one case (dx, dBm, dCm held here; ddt, dA into
        ``worst``) and the kernel's gradients."""
        exact = ref.ssd_scan_bwd_ref(*(t if t is None else t.double()
                                       for t in (x, dt, A, Bm, Cm, gy, gh)), chunk)
        got = ssd_scan_bwd_tc_kernel(x, dt, A, Bm, Cm, gy, gh, chunk)
        got32 = ssd_scan_bwd_tc_kernel(x, dt, A, Bm, Cm, gy, gh, chunk, torch.float32)
        plain32 = chunked(x, dt, A, Bm, Cm, gy, gh, chunk, torch.float32)
        torch.cuda.synchronize()
        gaps = {}
        for n, k, k32, p, e in zip(names, got, got32, plain32, exact):
            gaps[n] = dict(kernel=rel(k, e), kernel_f32=rel(k32, e),
                           ssd_chunked=rel(p.to(k.dtype), e), ssd_chunked_f32=rel(p, e))
            if not (bool(torch.isfinite(k).all()) and bool(torch.isfinite(k32).all())):
                raise AssertionError(f"ssd_scan_bwd {label} {n}: not finite")
            if n in worst:
                for side in ("kernel", "ssd_chunked"):
                    worst[n][side] = max(worst[n][side], gaps[n][side])
                continue
            tol = SSD_BWD_FACTOR * gaps[n]["ssd_chunked"]
            tol32 = max(SSD_BWD_F32_TOL, SSD_BWD_F32_FACTOR * gaps[n]["ssd_chunked_f32"])
            if not (gaps[n]["kernel"] <= tol and gaps[n]["kernel_f32"] <= tol32):
                raise AssertionError(f"ssd_scan_bwd {label} {n}: gaps {gaps[n]} (tolerance "
                                     f"{tol:.3e} returned, {tol32:.3e} float32)")
        return gaps, got

    gaps = {}
    for batch, S_, H_, chunk_, with_gh in ((B // 4, S, H, chunk, True), *SSD_BWD_SMALL):
        label = f"B{batch} S{S_} H{H_} chunk{chunk_} gh{int(with_gh)}"
        gaps[label], _ = check(label, *inputs(batch, S_, H_, with_gh, S_ * H_ + chunk_ + with_gh),
                               chunk_)
        torch.cuda.empty_cache()
    log("[kernels] ssd_scan_bwd cases " + json.dumps(gaps))

    rows = []
    for label, (B, S, H, P_, N_, chunk) in SSD_BWD_SHAPES.items():
        assert (P_, N_) == (P, N)
        x, dt, A, Bm, Cm, gy, _ = inputs(B, S, H, False, S * H + B)
        gaps[label], got = check(label, x, dt, A, Bm, Cm, gy, None, chunk)
        plain = chunked(x, dt, A, Bm, Cm, gy, None, chunk)
        max_abs = max(max_err(k, p) for k, p in zip(got, plain))
        del got, plain
        torch.cuda.empty_cache()

        def kern():
            return ssd_scan_bwd_tc_kernel(x, dt, A, Bm, Cm, gy, None, chunk)

        times = pass_times(f"ssd_scan_bwd {label}", kern, 10, KERNEL_NAMES["backward"])
        row = dict(
            name="ssd_scan_bwd", shape=label, B=B, S=S, H=H, P=P, N=N, chunk=chunk,
            dtype="bfloat16", body="tensor_cores", normwise_err=gaps[label],
            tol=dict(returned=f"{SSD_BWD_FACTOR} x ssd_chunked",
                     float32=f"max({SSD_BWD_F32_TOL}, {SSD_BWD_F32_FACTOR} x ssd_chunked_f32)",
                     log_decay=f"worst over the cases, {SSD_BWD_FACTOR} x ssd_chunked's"),
            max_abs_err=max_abs, ms=cuda_ms(kern, 10), device_ms=times["device_ms"],
            plain_ms=cuda_ms(lambda: chunked(x, dt, A, Bm, Cm, gy, None, chunk), 3),
            library_ms=None,
        )
        roofline(row, *ssd_work.backward(ssd_call(B, S, H, P, N, chunk, torch.bfloat16)))
        log("[kernels] " + json.dumps(row))
        log("[kernels] ssd_scan_bwd passes " + json.dumps(dict(
            shape=label, device_ms=times["device_ms"], all_kernels_ms=times["all_kernels_ms"],
            passes=times["passes"])))
        rows.append(row)
        del x, dt, A, Bm, Cm, gy
        torch.cuda.empty_cache()
    for n, w in worst.items():
        if not w["kernel"] <= SSD_BWD_FACTOR * w["ssd_chunked"]:
            raise AssertionError(f"ssd_scan_bwd {n}: worst gaps over the cases {w} "
                                 f"(tolerance {SSD_BWD_FACTOR} x ssd_chunked's)")
    for row in rows:
        row["worst_log_decay"] = worst
    return rows


def conv_work(B, S, C, W, dtype, backward=False):
    """(bytes, flops, peak flops) of one conv + SiLU call. Bytes: the forward
    reads x and writes its output once, the backward reads x and the
    output's gradient and writes dx once; w and b (and dw, db) besides.
    Operations an element: 2 W for the taps and the bias and 3 for the SiLU
    forward; backward that again, 5 for dpre and 4 W + 1 for dx, dw and db;
    at the CUDA cores' float32 rate (the kernels compute in float32)."""
    es = torch.finfo(dtype).bits // 8
    n = B * S * C
    if backward:
        return 3 * n * es + 2 * (W + 1) * C * es, (6 * W + 9) * n, PEAK_FLOPS[torch.float32]
    return 2 * n * es + (W + 1) * C * es, (2 * W + 3) * n, PEAK_FLOPS[torch.float32]


def phase_conv_kernels():
    """The Mamba-2 mixer's conv + SiLU kernels at the cells' calls
    (CONV_SHAPES, bf16, x the column slice of a (B, S, 8512) in-projection
    output, read in place), a row a direction: the forward against the
    plain expression F.silu(layers.causal_conv(...)) bit for bit; the
    backward's dx, dw, db against the f64 twin ``causal_conv_silu_bwd_ref``
    within CONV_BWD_FACTOR x the gap of autograd of the expression on the
    same inputs (float32 autograd from float32 leaves beside it), the same
    bits on a second run, and ``max_abs_err`` its largest gap to that
    autograd; each beside its bytes bound and the
    plain expression's time (autograd of it for the backward). No single
    PyTorch call computes the function, so no library time."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.causal_conv import (
        KERNEL_NAMES,
        causal_conv_silu_bwd_kernel,
        causal_conv_silu_kernel,
    )
    from repro_torch.models.layers import causal_conv

    di, width = CONV_IN_PROJ
    dt = torch.bfloat16

    def rel(got, want):
        return max_err(got, want) / max(want.abs().max().item(), 1e-30)

    def grads(x, w, b, gy, dtype):
        leaves = [t.to(dtype).detach().requires_grad_(True) for t in (x, w, b)]
        out = F.silu(causal_conv(*leaves))
        return torch.autograd.grad(out, leaves, gy.to(dtype))

    rows = []
    for label, (B, S, C, W) in CONV_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(B * S + C + W)
        x = torch.randn(B, S, width, generator=g, device="cuda").to(dt)[:, :, di:di + C]
        w = (0.2 * torch.randn(W, C, generator=g, device="cuda")).to(dt)
        b = (0.1 * torch.randn(C, generator=g, device="cuda")).to(dt)
        gy = torch.randn(B, S, C, generator=g, device="cuda").to(dt)

        def fwd():
            return causal_conv_silu_kernel(x, w, b)

        def plain():
            return F.silu(causal_conv(x, w, b))

        with torch.no_grad():
            got, want = fwd(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"causal_conv_silu {label}: {int((got != want).sum())} "
                                     "elements differ from the plain expression")
            del got, want
            times = pass_times(f"causal_conv_silu {label}", fwd, 10, KERNEL_NAMES["forward"])
            row = dict(name="causal_conv_silu", shape=label, B=B, S=S, C=C, W=W, dtype="bfloat16",
                       x_strides=list(x.stride()), bit_for_bit=True, max_abs_err=0.0,
                       ms=cuda_ms(fwd, 10), device_ms=times["device_ms"],
                       plain_ms=cuda_ms(plain, 5), library_ms=None)
        roofline(row, *conv_work(B, S, C, W, dt))
        log("[kernels] " + json.dumps(row))
        rows.append(row)

        def bwd():
            return causal_conv_silu_bwd_kernel(x, w, b, gy)

        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        del again
        exact = ref.causal_conv_silu_bwd_ref(*(t.double() for t in (x, w, b, gy)))
        plain16, f32 = grads(x, w, b, gy, dt), grads(x, w, b, gy, torch.float32)
        gaps = {}
        for n, k, p, q, e in zip(("dx", "dw", "db"), got, plain16, f32, exact):
            gaps[n] = dict(kernel=rel(k, e), autograd=rel(p, e),
                           float32_leaves_autograd=rel(q.to(dt), e))
            if not (bool(torch.isfinite(k).all())
                    and gaps[n]["kernel"] <= CONV_BWD_FACTOR * gaps[n]["autograd"]):
                raise AssertionError(f"causal_conv_silu_bwd {label} {n}: gaps {gaps[n]} "
                                     f"(tolerance {CONV_BWD_FACTOR} x autograd's)")
        if not same:
            raise AssertionError(f"causal_conv_silu_bwd {label}: two runs differ")
        max_abs = max(max_err(k, p) for k, p in zip(got, plain16))
        del exact, f32, plain16, got
        torch.cuda.empty_cache()
        times = pass_times(f"causal_conv_silu_bwd {label}", bwd, 10, KERNEL_NAMES["backward"])
        row = dict(name="causal_conv_silu_bwd", shape=label, B=B, S=S, C=C, W=W,
                   dtype="bfloat16", normwise_err=gaps,
                   tol=f"{CONV_BWD_FACTOR} x autograd of the plain expression",
                   same_bits=same, max_abs_err=max_abs, ms=cuda_ms(bwd, 10),
                   device_ms=times["device_ms"], passes=times["passes"],
                   plain_ms=cuda_ms(lambda: grads(x, w, b, gy, dt), 3), library_ms=None)
        roofline(row, *conv_work(B, S, C, W, dt, backward=True))
        log("[kernels] " + json.dumps(row))
        rows.append(row)
        del x, w, b, gy
        torch.cuda.empty_cache()
    return rows


def reset_launches() -> dict:
    """Zero the port's launch counter (`repro_torch.kernels._build.LAUNCHES`)
    and return it."""
    from repro_torch.kernels._build import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    return LAUNCHES


def read_launches(counters: dict) -> dict:
    return dict(counters)


def phase_serve(label, arch, batch, prompt_len, new_tokens, per_prefill, names,
                n_layers=None, f32_cut_layers=None):
    """Serve ``arch`` at full width in bf16 through the entry point (cut to
    ``n_layers`` layers when given, the cut logged), with the launch
    counts read around the run (``per_prefill``: each kernel's launches
    in the one prefill), then hold the prefill's kernel path against its
    plain path on the card: the whole prefill in bf16 and widened to f32;
    for an MoE model layer by layer in bf16 (`moe_layers_kernel_vs_plain`)
    and, with ``f32_cut_layers``, the whole prefill of a model of that
    many layers in f32 (`moe_f32_cut`). A vision-stub model's prefills
    get the serving entry point's stub embeddings. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, prefill_kwargs, serve
    from repro_torch.models import get_model

    cfg = get_config(arch)
    cut = ""
    if n_layers is not None:
        cut = f", depth cut {cfg.n_layers} -> {n_layers} layers, full width"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    seed = 0
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{label}] {cfg.name} {cfg.dtype}{cut}: {n_params / 1e9:.3f} B parameters "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    counters = reset_launches()
    r = serve(model, batch, prompt_len, new_tokens, seed)
    launches = read_launches(counters)
    toks = r["tokens"]
    log(f"[{label}] batch {batch} prompt {prompt_len} new {new_tokens}: prefill_s "
        f"{r['prefill_s']:.4f}, decode ms/token {r['decode_s_per_tok'] * 1e3:.3f}, "
        f"launches {launches}, first tokens {toks[0, :8].tolist()}")
    want = {k: 0 for k in launches}
    want.update(per_prefill)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} (one prefill)")
    in_vocab = 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab
    if tuple(toks.shape) != (batch, new_tokens) or not in_vocab:
        raise AssertionError(f"{label}: tokens {tuple(toks.shape)} out of range")

    prompts = make_prompts(cfg.vocab, batch, prompt_len, seed, "cuda")
    kw = prefill_kwargs(cfg, batch, "cuda")
    result = dict(prefill_s=r["prefill_s"], decode_ms_per_token=r["decode_s_per_tok"] * 1e3,
                  launches=launches)
    with torch.inference_mode():
        # A warm prefill's wall time without the profiler (median of 3,
        # synchronised): the profiled wall below includes the profiler's
        # own host time.
        logits, cache = model.prefill(prompts, extra_slots=new_tokens, **kw)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(prompts, extra_slots=new_tokens, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        result["warm_prefill_ms"] = float(np.median(walls))
        log(f"[{label}] warm prefill (no profiler, median of 3): "
            f"{result['warm_prefill_ms']:.2f} ms ({', '.join(f'{w:.2f}' for w in walls)})")
        # Where the time goes, warm, under the profiler (which adds host
        # time of its own): one prefill, then three decode steps.
        result["prefill_profile"] = profile_share(
            lambda: model.prefill(prompts, extra_slots=new_tokens, **kw), named=names)
        tok = logits[:, -1].argmax(-1, keepdim=True)

        def decode3():
            c = cache
            for _ in range(3):
                c = model.decode_step(c, tok)[1]

        result["decode_profile"] = profile_share(decode3, named=names)
        del cache
        log(f"[{label}] profile (warm): " + json.dumps(
            {k: result[k] for k in ("prefill_profile", "decode_profile")}))

    if cfg.family == "moe":
        # bf16 kernel and plain attention round differently, and a token
        # near a routing tie can then take another expert: hold layer by
        # layer on the tokens whose routes agree (the weights in f32 do
        # not fit the card at this depth).
        moe = moe_layers_kernel_vs_plain(label, model, cfg, prompts, kw, SERVE_TOL)
        moe["prefill_share"] = cfg.n_layers * moe["ffn_ms"] / result["warm_prefill_ms"]
        log(f"[{label}] MoE FFN (norm, router, dispatch, expert products, combine) of one "
            f"layer: {moe['ffn_ms']:.3f} ms, x {cfg.n_layers} layers = "
            f"{moe['prefill_share'] * 100:.1f}% of the warm prefill")
        result["moe"] = moe
        del model
        torch.cuda.empty_cache()
        if f32_cut_layers is not None:
            result["f32_cut"] = moe_f32_cut(label, arch, f32_cut_layers, batch, prompt_len,
                                            new_tokens)
        return result

    if cfg.family == "audio":
        # Whisper's attention is the plain path on either route (as in the
        # reference): there is no kernel path to hold against it.
        log(f"[{label}] no kernel route: attn_impl changes nothing for {cfg.family}")
        del model
        torch.cuda.empty_cache()
        return result

    with torch.inference_mode():
        # The kernel path against the plain path on the same weights: in
        # the served dtype, then widened to float32, where the two must
        # agree at f32 round-off through the whole depth.
        for dtype in (cfg.dtype, "float32"):
            if dtype == "float32":
                model.to(torch.float32)  # every weight; exact from bf16
            kcfg = dataclasses.replace(cfg, dtype=dtype)
            model.cfg = kcfg
            logits_k, cache_k = model.prefill(prompts, extra_slots=new_tokens, **kw)
            model.cfg = dataclasses.replace(kcfg, attn_impl="plain", ssm_impl="plain")
            logits_p, cache_p = model.prefill(prompts, extra_slots=new_tokens, **kw)
            model.cfg = cfg
            tol = SERVE_TOL if dtype == "bfloat16" else CARD_VS_CPU_TOL
            gap = hold(f"{label} {dtype} prefill logits kernel vs plain", logits_k, logits_p, tol)
            cgap = hold_cache(f"{label} {dtype} prefill", cache_k, cache_p, tol)
            log(f"[{label}] {dtype} prefill, kernel path vs plain path on the card: logits "
                f"normwise gap {gap:.3e}, worst cache gap {cgap:.3e} (tolerance {tol:.0e})")
            result[f"{dtype}_logits_gap"], result[f"{dtype}_cache_gap"] = gap, cgap
            del cache_k, cache_p
    del model
    torch.cuda.empty_cache()
    return result


# A bf16 serving phase's share of routes that the kernel and plain
# attention may flip (tokens whose top-k expert set differs between the two
# paths, through one layer from the same input): rounding differences move
# a token across a near-tie, and PERF.md records the share measured; a
# wrong kernel moves the attention output by its own size and flips most
# routes.
MOE_FLIP_LIMIT = 0.1


@torch.inference_mode()
def moe_layers_kernel_vs_plain(label, model, cfg, prompts, kw, tol):
    """An MoE model's prefill, layer by layer from the same input: each
    layer's attention on the kernel path and on the plain path, then the
    FFN on each. Per layer, the share of tokens whose top-k expert set
    differs (``flipped``), of tokens with the same set whose slots are kept
    or dropped differently (``drop_diff``), and the normwise gap of the
    layer's output over the tokens whose routes agree, held at ``tol``.
    The kernel path's output feeds the next layer. Also the wall ms of one
    layer's FFN on the kernel path (CUDA events)."""
    from repro_torch.models.layers import moe_capacity, moe_route, moe_slots
    from repro_torch.models.transformer import _ffn, _norm, _positions, _self_attention

    B, S = prompts.shape
    T, E, k, G = B * S, cfg.n_experts, cfg.experts_per_token, cfg.moe_groups
    C = moe_capacity(T // G, cfg.capacity_factor, k, E)
    paths = {impl: dataclasses.replace(cfg, attn_impl=impl) for impl in ("kernel", "plain")}
    x = model._embed(prompts, kw.get("extra_embeds"))
    positions = _positions(cfg, B, S, x.device)
    layers, worst, ffn_ms = [], 0.0, None
    for l, lp in enumerate(model.layers):
        out = {}
        for impl, c in paths.items():
            xa, _ = _self_attention(c, lp, x, positions)
            h = _norm(c, xa, lp.ln2, getattr(lp, "ln2_b", None))
            _, _, idx = moe_route(h.reshape(G, T // G, -1), lp.router, k)
            _, _, keep = moe_slots(idx, C, E)
            idx, keep = idx.reshape(T, k), keep.reshape(T, k)
            order = idx.argsort(-1)
            y, _ = _ffn(c, lp, xa)
            out[impl] = (idx.gather(-1, order), keep.gather(-1, order), y.reshape(T, -1))
            if impl == "kernel" and l == 0:
                ffn_ms = cuda_ms(lambda: _ffn(c, lp, xa), 5)
            del xa, h
        (ik, kk, yk), (ip, kp, yp) = out["kernel"], out["plain"]
        same_set = (ik == ip).all(-1)
        agree = same_set & (kk == kp).all(-1)
        ya, yb = yk[agree].float(), yp[agree].float()
        gap = normwise_gap(ya, yb)
        row = dict(layer=l, flipped=1.0 - same_set.float().mean().item(),
                   drop_diff=(same_set & ~agree).float().mean().item(),
                   dropped_slots=(~kk).float().mean().item(), agree_gap=gap)
        layers.append(row)
        worst = max(worst, gap)
        if not bool(torch.isfinite(yk).all()) or gap > tol or row["flipped"] > MOE_FLIP_LIMIT:
            raise AssertionError(f"{label} {cfg.dtype} layer {l}: {row} (tolerance {tol:.0e}, "
                                 f"flip limit {MOE_FLIP_LIMIT})")
        x = yk.reshape(B, S, -1)
        del out, ik, kk, yk, ip, kp, yp, ya, yb
    flipped = float(np.mean([r["flipped"] for r in layers]))
    drop_diff = float(np.mean([r["drop_diff"] for r in layers]))
    log(f"[{label}] {cfg.dtype} layer by layer, kernel vs plain attention from the same input "
        f"(C = {C} slots an expert): tokens with another expert set {flipped * 100:.3f}% "
        f"(worst layer {max(r['flipped'] for r in layers) * 100:.3f}%), same set but other "
        f"drops {drop_diff * 100:.3f}%, slots dropped {layers[0]['dropped_slots'] * 100:.2f}% "
        f"(layer 0); worst normwise gap over agreeing tokens {worst:.3e} (tolerance {tol:.0e})")
    return dict(capacity=C, flipped=flipped, drop_diff=drop_diff, worst_agree_gap=worst,
                layers=layers, ffn_ms=ffn_ms)


def moe_f32_cut(label, arch, n_layers, batch, prompt_len, new_tokens):
    """An f32 model of ``arch`` cut to ``n_layers`` layers (full width,
    random weights from seed 0): the whole prefill, logits and cache, on
    the kernel path against the plain path at CARD_VS_CPU_TOL, and the
    layer-by-layer route comparison (no route should flip at f32
    round-off)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import get_model

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32")
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    prompts = make_prompts(cfg.vocab, batch, prompt_len, 0, "cuda")
    with torch.inference_mode():
        logits_k, cache_k = model.prefill(prompts, extra_slots=new_tokens)
        model.cfg = dataclasses.replace(cfg, attn_impl="plain")
        logits_p, cache_p = model.prefill(prompts, extra_slots=new_tokens)
        model.cfg = cfg
        gap = hold(f"{label} float32 cut prefill logits kernel vs plain", logits_k, logits_p,
                   CARD_VS_CPU_TOL)
        cgap = hold_cache(f"{label} float32 cut prefill", cache_k, cache_p, CARD_VS_CPU_TOL)
        del cache_k, cache_p
    log(f"[{label}] float32, depth cut {full.n_layers} -> {n_layers} layers: prefill kernel "
        f"path vs plain path, logits normwise gap {gap:.3e}, worst cache gap {cgap:.3e} "
        f"(tolerance {CARD_VS_CPU_TOL:.0e})")
    layers = moe_layers_kernel_vs_plain(f"{label} f32 cut", model, cfg, prompts, {},
                                        CARD_VS_CPU_TOL)
    del model
    torch.cuda.empty_cache()
    return dict(logits_gap=gap, cache_gap=cgap, flipped=layers["flipped"],
                worst_agree_gap=layers["worst_agree_gap"])


def profile_share(fn, top: int = 5, named=()) -> dict:
    """Wall ms of ``fn`` (synchronised) under torch.profiler, the device's
    busy ms (sum of its kernels' and copies' device time), the ``top``
    kernels by device time and, for each of ``named`` (the port's kernels
    on this path), its device ms and launches whether in the top or not."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = []
    mine = {n: dict(ms=0.0, launches=0) for n in named}
    for ev in prof.key_averages():
        if device_us(ev) > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name.append((device_us(ev) / 1e3, ev.count, ev.key[:70]))
            for n in named:
                if n in ev.key:
                    mine[n]["ms"] += device_us(ev) / 1e3
                    mine[n]["launches"] += ev.count
    busy = sum(ms for ms, _, _ in by_name)
    by_name.sort(reverse=True)
    return dict(wall_ms=wall, device_busy_ms=busy, busy_share=busy / wall,
                top=[dict(name=n, ms=ms, launches=c) for ms, c, n in by_name[:top]],
                kernels=mine)


def grad_gap(got: dict, want: dict):
    """(gap, name) of the worst parameter by max |got - want| / max |want|."""
    worst = (0.0, "")
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient {name}: {tuple(g.shape)} finite={bool(torch.isfinite(g).all())}")
        worst = max(worst, (max_err(g, w) / max(w.abs().max().item(), 1e-30), name))
    return worst


def phase_train_mamba2():
    """mamba2-1.3b at full size: kernel path vs plain path (loss and
    gradients, bf16 on K4's tensor-core body and f32 on its CUDA-core
    body), then 5 Adam steps through the training entry point. Returns the
    K4 launches per training step."""
    from repro_torch.configs import get_config
    from repro_torch.data import agent_token_streams, make_lm_batch
    from repro_torch.distributed import PlainRuntime
    from repro_torch.kernels.ssd_scan import KERNEL_NAMES
    from repro_torch.launch import train
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), remat="full")
    B, S, L = 2, 4096, cfg.n_layers
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    stream = agent_token_streams(1, cfg.vocab, seed=0)[0]
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_lm_batch(stream, B, S).items()}
    log(f"[train-mamba2] {cfg.name}: {n_params / 1e9:.3f} B parameters, batch {B} x {S}, "
        f"remat {cfg.remat}")
    # K4's launches in one loss + backward on the kernel path: the body that
    # `ssd_body` picks, the tensor-core one in bf16 and the CUDA-core one in
    # f32, in the forward and its recomputation; in bf16 also the backward
    # kernel, once a layer (in f32 the backward is autograd of ssd_chunked);
    # the conv + SiLU kernel forward twice and backward once a layer in both.
    conv = {"causal_conv_silu": 2 * L, "causal_conv_silu_bwd": L}
    per_pass = {"bfloat16": {"ssd_scan_tc": 2 * L, "ssd_scan_bwd_tc": L, **conv},
                "float32": {"ssd_scan": 2 * L, **conv}}
    result, out = {}, {}
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            model.to(torch.float32)  # every weight; exact from bf16
        for impl in ("kernel", "plain"):
            model.cfg = dataclasses.replace(cfg, dtype=dtype, ssm_impl=impl)
            counters = reset_launches()
            t0 = time.perf_counter()
            loss, _ = model.loss(batch)
            loss.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches(counters)
            out[(dtype, impl)] = (loss.detach(),
                                  {n: p.grad for n, p in model.named_parameters()})
            model.zero_grad(set_to_none=True)
            want = {k: 0 for k in launches}
            if impl == "kernel":
                want.update(per_pass[dtype])
            if launches != want:
                raise AssertionError(f"train-mamba2 {dtype} {impl}: launches {launches}, want {want}")
            log(f"[train-mamba2] {dtype} {impl} path: loss {loss.item():.6f}, "
                f"loss + backward {seconds:.3f} s, launches {launches}")
    # f32 at f32 round-off; bf16 within 2 x the spread of plain bf16 vs plain
    # f32, the rule of the other bf16 LM checks (the tensor-core body is
    # held to the f64 witness in `phase_train_mamba2_witness`, and the
    # CUDA-core body to 5e-2 of plain bf16 there).
    g_bound, _, _ = spread_bound("train-mamba2", out[("bfloat16", "plain")][1],
                                 out[("float32", "plain")][1])
    bounds = {"float32": TRAIN_TOL["float32"]["grad"], "bfloat16": g_bound}
    for dtype in ("float32", "bfloat16"):
        (lk, gk), (lp, gp) = out.pop((dtype, "kernel")), out[(dtype, "plain")]
        loss_gap = abs(lk.item() - lp.item()) / abs(lp.item())
        g_gap, g_name = grad_gap(gk, gp)
        tol = TRAIN_TOL[dtype]["loss"]
        log(f"[train-mamba2] {dtype}, kernel path vs plain path: loss relative gap "
            f"{loss_gap:.3e} (tolerance {tol:.0e}), worst parameter gradient gap "
            f"{g_gap:.3e} at {g_name} (bound {bounds[dtype]:.3e})")
        if not (np.isfinite(lk.item()) and loss_gap <= tol and g_gap <= bounds[dtype]):
            raise AssertionError(f"train-mamba2 {dtype}: kernel vs plain beyond tolerance")
        result[f"{dtype}_loss_gap"], result[f"{dtype}_grad_gap"] = loss_gap, g_gap
        del gk, gp
    del out, model
    torch.cuda.empty_cache()

    # The training entry point: 5 Adam steps (lr 3e-4, clip 1.0) in bf16.
    steps = 5
    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = train.main(["--arch", "mamba2-1.3b", "--batch", str(B), "--seq", str(S),
                      "--steps", str(steps), "--log-every", "1", "--seed", "0"])
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    want = {k: 0 for k in launches}
    want.update({k: steps * n for k, n in per_pass["bfloat16"].items()})
    if launches != want:
        raise AssertionError(f"train-mamba2: launches {launches}, want {want} ({steps} steps)")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train-mamba2: losses {losses}")
    warm = float(np.median(run["step_s"][1:]))
    log(f"[train-mamba2] {steps} steps: losses {json.dumps(losses)}, step s "
        f"{json.dumps(run['step_s'])}, warm step {warm:.4f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, K4 launches {launches['ssd_scan_tc']} "
        f"({launches['ssd_scan_tc'] // steps} per step, the tensor-core body), K4 backward "
        f"launches {launches['ssd_scan_bwd_tc']} ({launches['ssd_scan_bwd_tc'] // steps} per step), "
        f"conv + SiLU launches {launches['causal_conv_silu']} forward, "
        f"{launches['causal_conv_silu_bwd']} backward")
    rt = PlainRuntime(run["model"], lr=3e-4)
    state = run["state"]
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_lm_batch(stream, B, S).items()}
    prof = profile_share(lambda: rt.train_step(state, batch), top=8,
                         named=sorted({n for names in KERNEL_NAMES.values() for n in names}))
    log("[train-mamba2] profile of one warm step: " + json.dumps(prof))
    # K4's tensor-core body runs each of its passes 2 L times and the
    # backward kernel each of its passes L times (the scores pass is in
    # both); the CUDA-core body, never.
    k4 = {n: v["launches"] for n, v in prof["kernels"].items()}
    want = {n: (2 * L if n in KERNEL_NAMES["tensor_cores"] else 0)
            + (L if n in KERNEL_NAMES["backward"] else 0) for n in k4}
    if k4 != want:
        raise AssertionError(f"train-mamba2 profiled step: K4 launches {k4}, want {want}")
    k4_ms = sum(v["ms"] for v in prof["kernels"].values())
    log(f"[train-mamba2] K4 in the profiled warm step: {k4_ms:.3f} ms of device time over "
        f"{sum(k4.values())} launches ({prof['device_busy_ms']:.1f} ms busy in "
        f"{prof['wall_ms']:.1f} ms of wall); warm step {warm:.4f} s")
    result.update(losses=losses, warm_step_s=warm, peak_bytes=peak, profile=prof,
                  k4_device_ms=k4_ms, launches_per_step=launches["ssd_scan_tc"] // steps,
                  bwd_launches_per_step=launches["ssd_scan_bwd_tc"] // steps,
                  conv_launches_per_step=launches["causal_conv_silu"] // steps,
                  conv_bwd_launches_per_step=launches["causal_conv_silu_bwd"] // steps)
    del run, rt, state, batch
    torch.cuda.empty_cache()
    return result


# ---- training of the dense and hybrid families, and consensus training ---


def param_dtypes(model) -> dict:
    return {n: p.dtype for n, p in model.named_parameters()}


@torch.no_grad()
def restore_dtypes(model, dtypes: dict) -> None:
    """Each parameter back to its own dtype (model.to(bf16) would also
    round the float32 ones: the RG-LRU gates' biases, mamba2's A_log)."""
    for n, p in model.named_parameters():
        p.data = p.data.to(dtypes[n])


def loss_and_grads(model, cfg, batch):
    """(loss, {name: grad}, launches, seconds) of one loss + backward with
    ``model.cfg = cfg``."""
    model.cfg = cfg
    counters = reset_launches()
    t0 = time.perf_counter()
    loss, _ = model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(counters)
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, launches, seconds


@torch.no_grad()
def token_nll(model, cfg, batch) -> torch.Tensor:
    """Each token's NLL (B, S) in f32 from ``model.cfg = cfg``'s forward
    (every family's ``forward`` returns the final-normed hidden states)."""
    model.cfg = cfg
    out = model.forward(batch["tokens"])
    hidden = out[0] if isinstance(out, tuple) else out
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    # granite divides the hidden state by its logits_scaling before the head
    logits = (model._logits(hidden) if cfg.family == "granite" else hidden @ head).float()
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def spread_bound(label, got16: dict, want32: dict):
    """The bf16 bound of a check: the worst normwise gap between two correct
    computations of the same step (the plain path in bf16 and in f32 from
    the same weights, ``got16`` against ``want32``), times 2. Returns
    (bound, spread, worst name)."""
    spread, name = grad_gap(got16, want32)
    log(f"[{label}] spread of correct paths: plain bf16 vs plain f32 {spread:.3e} at "
        f"{name}; bound 2 x spread = {2 * spread:.3e}")
    return 2 * spread, spread, name


def kernel_vs_plain_training(label, model, cfg, batch, per_pass):
    """The loss and every parameter's gradient on the kernel path against
    the plain path from the same weights and batch: in f32 (widened) at
    TRAIN_TOL["float32"], in bf16 within 2 x the spread between the plain
    path in bf16 and in f32. In bf16 the loss is held token by token
    (normwise over the B x S token NLLs): the mean of 8,192 token losses
    is one sample of bf16 noise, and two paths can land close by chance
    (the first reading: plain bf16 vs f32 1.3e-6 apart, the kernel path
    1.2e-5 from each; its gradients well inside their bound); the mean's
    gap is printed beside it. ``per_pass``: each kernel's launches in one
    loss + backward on the kernel path (none on the plain path), or
    {dtype: that} where the dtypes launch different kernels (K4's body)."""
    dtypes = param_dtypes(model)
    out, nll = {}, {}
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            model.to(torch.float32)  # every weight; exact from bf16
        for impl in ("kernel", "plain"):
            c = dataclasses.replace(cfg, dtype=dtype, attn_impl=impl, ssm_impl=impl)
            nll[(dtype, impl)] = token_nll(model, c, batch)
            loss, grads, launches, seconds = loss_and_grads(model, c, batch)
            want = {k: 0 for k in launches}
            if impl == "kernel":
                want.update(per_pass.get(dtype, per_pass))
            if launches != want:
                raise AssertionError(f"{label} {dtype} {impl}: launches {launches}, want {want}")
            log(f"[{label}] {dtype} {impl} path: loss {loss.item():.6f}, loss + backward "
                f"{seconds:.3f} s, launches {launches}")
            out[(dtype, impl)] = (loss, grads)
            del grads
            torch.cuda.empty_cache()
    model.cfg = cfg
    (lk16, gk16), (lp16, gp16) = out.pop(("bfloat16", "kernel")), out.pop(("bfloat16", "plain"))
    (lk32, gk32), (lp32, gp32) = out.pop(("float32", "kernel")), out.pop(("float32", "plain"))
    result = {}
    tol = TRAIN_TOL["float32"]
    loss_gap = abs(lk32.item() - lp32.item()) / abs(lp32.item())
    g_gap, g_name = grad_gap(gk32, gp32)
    del gk32
    log(f"[{label}] float32, kernel path vs plain path: loss relative gap {loss_gap:.3e} "
        f"(tolerance {tol['loss']:.0e}), worst parameter gradient gap {g_gap:.3e} at "
        f"{g_name} (tolerance {tol['grad']:.0e})")
    if not (np.isfinite(lk32.item()) and loss_gap <= tol["loss"] and g_gap <= tol["grad"]):
        raise AssertionError(f"{label} float32: kernel vs plain beyond tolerance")
    result.update(float32_loss_gap=loss_gap, float32_grad_gap=g_gap)
    nll_spread = normwise_gap(nll[("bfloat16", "plain")], nll[("float32", "plain")])
    nll_gap = normwise_gap(nll[("bfloat16", "kernel")], nll[("bfloat16", "plain")])
    mean_spread = abs(lp16.item() - lp32.item()) / abs(lp32.item())
    mean_gap = abs(lk16.item() - lp16.item()) / abs(lp16.item())
    g_bound, g_spread, _ = spread_bound(label, gp16, gp32)
    del gp32
    restore_dtypes(model, dtypes)
    g_gap, g_name = grad_gap(gk16, gp16)
    log(f"[{label}] bfloat16, kernel path vs plain path: token losses normwise gap "
        f"{nll_gap:.3e} (spread {nll_spread:.3e}, bound 2 x spread {2 * nll_spread:.3e}); "
        f"mean loss relative gap {mean_gap:.3e} (plain bf16 vs f32 {mean_spread:.3e}); worst "
        f"parameter gradient gap {g_gap:.3e} at {g_name} (bound 2 x spread {g_bound:.3e})")
    if not (np.isfinite(lk16.item()) and nll_gap <= 2 * nll_spread and g_gap <= g_bound):
        raise AssertionError(f"{label} bfloat16: kernel vs plain beyond the spread bound")
    result.update(bfloat16_token_loss_gap=nll_gap, bfloat16_token_loss_bound=2 * nll_spread,
                  bfloat16_mean_loss_gap=mean_gap, bfloat16_mean_loss_spread=mean_spread,
                  bfloat16_grad_gap=g_gap, bfloat16_grad_bound=g_bound)
    return result


def lm_batch(vocab, B, S, seed=0):
    from repro_torch.data import agent_token_streams, make_lm_batch

    stream = agent_token_streams(1, vocab, seed=seed)[0]
    return {k: torch.from_numpy(v).cuda() for k, v in make_lm_batch(stream, B, S).items()}


def phase_train_qwen3(steps=5):
    """qwen3-0.6b at full size (28 layers), bf16, batch 4 x 2048, remat
    "full": kernel vs plain loss and gradients (K3's forward twice and its
    backward once a layer), then ``steps`` Adam steps through the training
    entry point and a profile of one more warm step."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import PlainRuntime
    from repro_torch.launch import train
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), remat="full")
    B, S, L = 4, 2048, cfg.n_layers
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(True)
    log(f"[train-qwen3] {cfg.name}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters, batch {B} x {S}, remat {cfg.remat}")
    per_pass = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    result = kernel_vs_plain_training("train-qwen3", model, cfg, lm_batch(cfg.vocab, B, S), per_pass)
    del model
    torch.cuda.empty_cache()

    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = train.main(["--arch", "qwen3-0.6b", "--batch", str(B), "--seq", str(S),
                      "--steps", str(steps), "--log-every", "1", "--seed", "0"])
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want.update({k: steps * n for k, n in per_pass.items()})
    if launches != want:
        raise AssertionError(f"train-qwen3: launches {launches}, want {want} ({steps} steps)")
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train-qwen3: losses {losses}")
    warm = float(np.median(run["step_s"][1:]))
    log(f"[train-qwen3] {steps} steps: losses {json.dumps(losses)}, step s "
        f"{json.dumps(run['step_s'])}, warm step {warm:.4f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches per step "
        f"{json.dumps({k: v // steps for k, v in launches.items() if v})}")
    rt = PlainRuntime(run["model"], lr=3e-4)
    state, batch = run["state"], lm_batch(cfg.vocab, B, S, seed=1)
    prof = profile_share(lambda: rt.train_step(state, batch), top=8,
                         named=K3_KERNELS + K3_BWD_KERNELS)
    log("[train-qwen3] profile of one warm step: " + json.dumps(prof))
    result.update(losses=losses, warm_step_s=warm, peak_bytes=peak, profile=prof,
                  launches_per_step={k: v // steps for k, v in launches.items()})
    del run, rt, state, batch
    torch.cuda.empty_cache()
    return result


def phase_train_rg(steps=5, n_layers=6):
    """recurrentgemma-9b at full width cut to ``n_layers`` layers (two
    [rec, rec, attn] groups: all 38 layers with Adam's moments do not fit
    one card), bf16, batch 1 x 4096 (beyond the 2048 window), remat "full":
    kernel vs plain loss and gradients (K3 and K5, forward twice and
    backward once a layer), then ``steps`` Adam steps through
    `launch.train.run_plain` on the cut model."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.models.rglru import _counts

    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, n_layers=n_layers, remat="full")
    B, S = 1, 4096
    G, R, T = _counts(cfg)
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(True)
    log(f"[train-rg] {cfg.name}: depth cut {full.n_layers} -> {n_layers} layers ({G} groups "
        f"of {R} recurrent + 1 attention, {T} tail), full width: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, batch {B} x {S}, "
        f"window {cfg.sliding_window}, remat {cfg.remat}")
    n_rec = G * R + T
    per_pass = {"flash_attention": 2 * G, "flash_attention_bwd": G,
                "rglru_scan": 2 * n_rec, "rglru_scan_bwd": n_rec}
    result = kernel_vs_plain_training("train-rg", model, cfg, lm_batch(cfg.vocab, B, S), per_pass)

    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    args = SimpleNamespace(lr=3e-4, seed=0, steps=steps, batch=B, seq=S, log_every=1,
                           ckpt_dir=None, ckpt_every=100)
    run = train.run_plain(model, args)
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want.update({k: steps * n for k, n in per_pass.items()})
    if launches != want:
        raise AssertionError(f"train-rg: launches {launches}, want {want} ({steps} steps)")
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train-rg: losses {losses}")
    warm = float(np.median(run["step_s"][1:]))
    log(f"[train-rg] {steps} steps: losses {json.dumps(losses)}, step s "
        f"{json.dumps(run['step_s'])}, warm step {warm:.4f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches per step "
        f"{json.dumps({k: v // steps for k, v in launches.items() if v})}")
    result.update(losses=losses, warm_step_s=warm, peak_bytes=peak,
                  launches_per_step={k: v // steps for k, v in launches.items()})
    del model, run
    torch.cuda.empty_cache()
    return result


def phase_train_granite(steps=3, n_layers=6):
    """granite-4.0-h-micro at its benchmark cell's step (bf16, 2 rows of
    8192, remat "full"). The whole model first: ``steps`` Adam steps
    through the training entry point, then one more step of its runtime
    with the launch counts zeroed just before it (K4's tensor-core forward
    twice and its backward kernel once a Mamba layer, K3's forward twice
    and its backward once an attention layer), and a profile of one warm
    step. Then the loss and gradients on the kernel path against the plain
    path at full width cut to ``n_layers`` layers (five Mamba mixers and
    the attention mixer at index 5), in bf16 and widened to f32, at the
    same rows (`kernel_vs_plain_training`)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import PlainRuntime
    from repro_torch.kernels.ssd_scan import KERNEL_NAMES
    from repro_torch.launch import train
    from repro_torch.models import get_model

    arch = "granite-4.0-h-micro"
    full = dataclasses.replace(get_config(arch), remat="full")
    B, S = 2, 8192

    def per_pass(cfg):
        Lm, La = cfg.layer_types.count("mamba"), cfg.layer_types.count("attention")
        k3 = {"flash_attention": 2 * La, "flash_attention_bwd": La,
              "causal_conv_silu": 2 * Lm, "causal_conv_silu_bwd": Lm}
        return {"bfloat16": {"ssd_scan_tc": 2 * Lm, "ssd_scan_bwd_tc": Lm, **k3},
                "float32": {"ssd_scan": 2 * Lm, **k3}}

    want_step = per_pass(full)["bfloat16"]
    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = train.main(["--arch", arch, "--batch", str(B), "--seq", str(S),
                      "--steps", str(steps), "--log-every", "1", "--seed", "0"])
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want.update({k: steps * n for k, n in want_step.items()})
    if launches != want:
        raise AssertionError(f"train-granite: launches {launches}, want {want} ({steps} steps)")
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train-granite: losses {losses}")
    warm = float(np.median(run["step_s"][1:]))
    log(f"[train-granite] {arch}: {full.param_count() / 1e9:.3f} B parameters, batch {B} x {S}, "
        f"remat {full.remat}; {steps} steps: losses {json.dumps(losses)}, step s "
        f"{json.dumps(run['step_s'])}, warm step {warm:.4f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB")

    rt = PlainRuntime(run["model"], lr=3e-4)
    state = run["state"]
    batch = lm_batch(full.vocab, B, S, seed=1)
    counters = reset_launches()
    state, _ = rt.train_step(state, batch)
    torch.cuda.synchronize()
    one_step = {k: v for k, v in read_launches(counters).items() if v}
    if one_step != want_step:
        raise AssertionError(f"train-granite: one step's launches {one_step}, want {want_step}")
    log(f"[train-granite] launches in one step of the runtime (counts zeroed just before it): "
        f"{json.dumps(one_step)}")
    names = K3_KERNELS + K3_BWD_KERNELS + tuple(
        sorted({n for group in KERNEL_NAMES.values() for n in group}))
    prof = profile_share(lambda: rt.train_step(state, batch), top=8, named=names)
    log("[train-granite] profile of one warm step: " + json.dumps(prof))
    result = dict(losses=losses, warm_step_s=warm, peak_bytes=peak, profile=prof,
                  launches_per_step=one_step)
    del run, rt, state, batch
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, n_layers=n_layers, layer_types=full.layer_types[:n_layers])
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(True)
    log(f"[train-granite] depth cut {full.n_layers} -> {n_layers} layers "
        f"({json.dumps(list(cfg.layer_types))}), full width: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, batch {B} x {S}")
    result.update(kernel_vs_plain_training("train-granite", model, cfg,
                                           lm_batch(cfg.vocab, B, S), per_pass(cfg)))
    del model
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def recorded_routes():
    """Every MoE layer's routes while the block runs: a list that gains,
    a layer at a time, each token's (expert set sorted, kept or dropped
    in the same order) as one (T, 2k) tensor, tokens in order."""
    import repro_torch.models.layers as layers_mod

    route, slots, out, pending = layers_mod.moe_route, layers_mod.moe_slots, [], []

    def rec_route(xg, router, k):
        probs, gates, idx = route(xg, router, k)
        pending.append(idx)
        return probs, gates, idx

    def rec_slots(gate_idx, capacity, n_experts):
        flat_e, pos, keep = slots(gate_idx, capacity, n_experts)
        idx = pending.pop()
        k = idx.shape[-1]
        order = idx.argsort(-1)
        kept = keep.reshape(idx.shape).gather(-1, order)
        out.append(torch.cat([idx.gather(-1, order), kept.to(idx.dtype)], -1).reshape(-1, 2 * k))
        return flat_e, pos, keep

    layers_mod.moe_route, layers_mod.moe_slots = rec_route, rec_slots
    try:
        yield out
    finally:
        layers_mod.moe_route, layers_mod.moe_slots = route, slots


def agreeing_token_grads(label, model, cfg, batch, all_tokens: dict) -> dict:
    """An MoE model's bf16 gradients held on the tokens whose routes (expert
    set and drops) agree in every layer across the three paths compared,
    kernel and plain bf16 and plain f32 (ROADMAP Queue 3 item 3): the
    other tokens' labels set to -1, which the loss leaves out (the aux
    loss still reads every token, and a flipped token's layer output still
    reaches later tokens through attention). Kernel bf16 vs plain bf16,
    held within 2 x the spread of plain bf16 vs plain f32 on the same
    masked batch, printed beside the all-token reading."""
    dtypes = param_dtypes(model)
    paths = (("bfloat16", "kernel"), ("bfloat16", "plain"), ("float32", "plain"))
    routes = {}
    for dtype, impl in paths:
        if dtype == "float32":
            model.to(torch.float32)  # every weight; exact from bf16
        model.cfg = dataclasses.replace(cfg, dtype=dtype, attn_impl=impl)
        with recorded_routes() as rec, torch.no_grad():
            model.forward(batch["tokens"])
        routes[(dtype, impl)] = rec
    restore_dtypes(model, dtypes)
    model.cfg = cfg
    first = routes[paths[0]]
    agree = torch.ones(batch["tokens"].numel(), dtype=torch.bool, device=batch["tokens"].device)
    for path in paths[1:]:
        for a, b in zip(first, routes[path]):
            agree &= (a == b).all(-1)
    agree = agree.reshape(batch["tokens"].shape)
    del routes, first
    masked = dict(batch, labels=torch.where(agree, batch["labels"], -1))
    grads = {}
    for dtype, impl in paths:
        if dtype == "float32":
            model.to(torch.float32)
        c = dataclasses.replace(cfg, dtype=dtype, attn_impl=impl)
        _, grads[(dtype, impl)], _, _ = loss_and_grads(model, c, masked)
    restore_dtypes(model, dtypes)
    model.cfg = cfg
    bound, spread, _ = spread_bound(f"{label} agreeing tokens",
                                    grads[("bfloat16", "plain")], grads[("float32", "plain")])
    gap, at = grad_gap(grads[("bfloat16", "kernel")], grads[("bfloat16", "plain")])
    share = agree.float().mean().item()
    log(f"[{label}] bfloat16 gradients, kernel path vs plain path: on the {share * 100:.3f}% of "
        f"tokens whose routes agree in every layer across the three paths, worst parameter "
        f"gap {gap:.3e} at {at} (bound 2 x spread {bound:.3e}); on all tokens "
        f"{all_tokens['bfloat16_grad_gap']:.3e} (bound {all_tokens['bfloat16_grad_bound']:.3e})")
    if gap > bound:
        raise AssertionError(f"{label} bfloat16 on agreeing tokens: kernel vs plain beyond "
                             f"the spread bound")
    return dict(agreeing_share=share, grad_gap=gap, grad_bound=bound, spread=spread)


def phase_train_phi35(steps=5, n_layers=2):
    """phi3.5-moe at full width cut to ``n_layers`` layers (the 32 layers'
    42 B parameters do not fit one card), bf16, batch 2 x 2048, remat
    "full": kernel vs plain loss and gradients (the routers' included; K3's
    forward twice and its backward once a layer), then ``steps`` Adam steps
    through `launch.train.run_plain`, a profile of one more warm step, and
    the wall ms of one layer's MoE FFN forward and forward + backward."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.distributed import PlainRuntime
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.models.transformer import _ffn, _positions, _self_attention

    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(full, n_layers=n_layers, remat="full")
    B, S, L = 2, 2048, n_layers
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model.requires_grad_(True)
    log(f"[train-phi35] {cfg.name}: depth cut {full.n_layers} -> {L} layers, full width: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, batch {B} x {S}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token}, capacity factor "
        f"{cfg.capacity_factor}, remat {cfg.remat}")
    per_pass = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    batch = lm_batch(cfg.vocab, B, S)
    result = kernel_vs_plain_training("train-phi35", model, cfg, batch, per_pass)
    result["agreeing_tokens"] = agreeing_token_grads("train-phi35", model, cfg, batch, result)
    del batch

    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    args = SimpleNamespace(lr=3e-4, seed=0, steps=steps, batch=B, seq=S, log_every=1,
                           ckpt_dir=None, ckpt_every=100)
    run = train.run_plain(model, args)
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want.update({k: steps * n for k, n in per_pass.items()})
    if launches != want:
        raise AssertionError(f"train-phi35: launches {launches}, want {want} ({steps} steps)")
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train-phi35: losses {losses}")
    warm = float(np.median(run["step_s"][1:]))
    log(f"[train-phi35] {steps} steps: losses {json.dumps(losses)}, step s "
        f"{json.dumps(run['step_s'])}, warm step {warm:.4f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches per step "
        f"{json.dumps({k: v // steps for k, v in launches.items() if v})}")
    rt = PlainRuntime(model, lr=3e-4)
    state, batch = run["state"], lm_batch(cfg.vocab, B, S, seed=1)
    prof = profile_share(lambda: rt.train_step(state, batch), top=8,
                         named=K3_KERNELS + K3_BWD_KERNELS)
    log("[train-phi35] profile of one warm step: " + json.dumps(prof))

    # One layer's MoE FFN on a hidden state of the step's shape: a step runs
    # it forward twice (remat) and backward once in each layer.
    lp = model.layers[0]
    with torch.no_grad():
        x = model._embed(batch["tokens"])
        xa = _self_attention(cfg, lp, x, _positions(cfg, B, S, x.device))[0]
    xa.requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return _ffn(cfg, lp, xa)

    def fwd_bwd():
        y, aux = _ffn(cfg, lp, xa)
        (y.float().sum() + aux).backward()

    fwd_ms, fwd_bwd_ms = cuda_ms(fwd, 3), cuda_ms(fwd_bwd, 3)
    model.zero_grad(set_to_none=True)
    share = L * (fwd_ms + fwd_bwd_ms) / (warm * 1e3)
    log(f"[train-phi35] MoE FFN of one layer: forward {fwd_ms:.3f} ms, forward + backward "
        f"{fwd_bwd_ms:.3f} ms; x {L} layers (forward, recomputation, backward) = "
        f"{share * 100:.1f}% of the warm step")
    result.update(losses=losses, warm_step_s=warm, peak_bytes=peak, profile=prof,
                  launches_per_step={k: v // steps for k, v in launches.items()},
                  moe_ffn_fwd_ms=fwd_ms, moe_ffn_fwd_bwd_ms=fwd_bwd_ms, moe_step_share=share)
    del model, run, rt, state, batch, x, xa
    torch.cuda.empty_cache()
    return result


def consensus_args(**kw):
    """`launch.train`'s consensus arguments (its defaults) at the phases'
    size: A 2, K 4, S 1, cyclic, P_rows 1 (16 rows a step), seq 2048."""
    from types import SimpleNamespace

    base = dict(agents=2, ecns=4, stragglers=1, scheme="cyclic", rho=1.0, c_tau=20.0,
                c_gamma=0.1, consensus_mode="incremental", seed=0, steps=5, batch=16,
                seq=2048, log_every=1, ckpt_dir=None, ckpt_every=100)
    base.update(kw)
    return SimpleNamespace(**base)


def ulp(want: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The unit in the last place of ``want`` (f64) in ``dtype``."""
    _, e = torch.frexp(want)
    u = torch.ldexp(torch.ones_like(want), e - 1) * torch.finfo(dtype).eps
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def phase_consensus(label, arch, fwd_uses, bwd_uses, steps=5, n_layers=None, seq=2048):
    """csI-ADMM training of ``arch`` at full size (full width and
    ``n_layers`` layers when given) through
    `launch.train.run_consensus`: ``steps`` incremental steps and one
    parallel step, with launches (``fwd_uses``/``bwd_uses``: each kernel's
    launches in one forward / backward of one agent), step seconds and peak
    memory; ``seq`` tokens a row (an audio-stub model's rows carry the
    launcher's stand-in frames too). When the incremental run's peak and a
    second state would not fit the card together, that state waits on the
    host while the parallel run holds the card, and the checks keep their
    copies (the committing agent's x and y, each z+) on the host, bringing
    one leaf at a time back to compare; the f32 step of the spread then
    runs from a state whose agents share the committing agent's x and y
    (all that z+ reads). Then, from the
    incremental run's final state, one more incremental step checked on
    the card:
    (i)   the agent that does not commit keeps x and y bit for bit;
    (ii)  z+ - z = (1/A) [(x_a+ - x_a) - (y_a+ - y_a) / rho], recomputed in
          f64 from the saved tensors, within the rounding of the f32
          update: 2 ulps of z+ in its dtype plus 4 f32 ulps of each term
          (|x_a+| + |x_a| + (|y_a+| + |y_a|) / rho) / A (a leaf near 0
          whose y is large rounds at y's scale);
    (iii) two one-straggler alive masks give the same z+ (eq. 6), and
    (iv)  the kernel route the plain route's z+, each within 2 x the
          spread between two correct computations of the step (the plain
          route with the model in bf16 and widened to f32, the state as
          stored): the worst leaf's normwise gap."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import get_model

    full = get_config(arch)
    cfg = dataclasses.replace(full, remat="full")
    cut = ""
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        cut = f", depth cut {full.n_layers} -> {n_layers} layers, full width"
    model = get_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    log(f"[{label}] {cfg.name} {cfg.dtype}{cut}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters; A 2, K 4, S 1, "
        f"cyclic, P_rows 1, seq {seq} (16 rows a step), remat {cfg.remat}")
    result = {}
    for mode, n_steps, fwd, bwd in (("incremental", steps, 3, 1), ("parallel", 1, 4, 2)):
        # incremental: the committing agent's forward, its recomputation and
        # backward, and the other agent's forward for the metrics; parallel:
        # both agents forward, recompute and backward.
        counters = reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = train.run_consensus(
            model, consensus_args(steps=n_steps, consensus_mode=mode, seq=seq))
        launches = read_launches(counters)
        peak = torch.cuda.max_memory_allocated()
        want = {k: 0 for k in launches}
        want.update({k: n_steps * fwd * n for k, n in fwd_uses.items()})
        want.update({k: n_steps * bwd * n for k, n in bwd_uses.items()})
        if launches != want:
            raise AssertionError(f"{label} {mode}: launches {launches}, want {want}")
        if not (np.isfinite(out["losses"]).all() and np.isfinite(out["residuals"]).all()):
            raise AssertionError(f"{label} {mode}: losses {out['losses']}")
        log(f"[{label}] {n_steps} {mode} steps: losses {json.dumps(out['losses'])}, "
            f"residuals {json.dumps(out['residuals'])}, step s {json.dumps(out['step_s'])}, "
            f"peak device memory {peak / 2**30:.2f} GiB, launches per step "
            f"{json.dumps({k: v // n_steps for k, v in launches.items() if v})}")
        result[mode] = dict(losses=out["losses"], residuals=out["residuals"],
                            step_s=out["step_s"], peak_bytes=peak,
                            launches_per_step={k: v // n_steps for k, v in launches.items()})
        if mode == "incremental":
            rt, state = out["runtime"], out["state"]
            state_bytes = sum(t.numel() * t.element_size()
                              for key in ("x", "y", "z") for t in state[key].values())
            host = peak + state_bytes > torch.cuda.get_device_properties(0).total_memory
            log(f"[{label}] state {state_bytes / 2**30:.2f} GiB beside the run's peak: "
                f"{'to the host' if host else 'kept on the card'} for the parallel run")
            if host:  # off the card while the parallel run holds its own state
                t0 = time.perf_counter()
                for key in ("x", "y", "z"):
                    state[key] = {n: t.cpu() for n, t in state[key].items()}
                log(f"[{label}] incremental state to the host: "
                    f"{time.perf_counter() - t0:.2f} s")
        del out
        torch.cuda.empty_cache()
    for key in ("x", "y", "z"):
        state[key] = {n: t.cuda() for n, t in state[key].items()}

    def park(tensors: dict) -> dict:
        return {n: t.cpu() for n, t in tensors.items()} if host else tensors

    # One more incremental step from the same state, four ways.
    A = rt.cfg.n_agents
    batch_np, alive1 = next(train.consensus_batches(
        consensus_args(seed=1, steps=1, seq=seq), rt.cfg.code(), cfg.vocab, cfg))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    alive2 = np.roll(alive1, 1, axis=1)  # another ECN straggles, one per agent
    active = state["k"] % A  # (k + 1 - 1) mod A
    other = (active + 1) % A
    X, Y, Z, rho = state["x"], state["y"], state["z"], rt.cfg.rho
    xa = park({n: t[active].clone() for n, t in X.items()})
    ya = park({n: t[active].clone() for n, t in Y.items()})

    def step(impl, alive, dtype=cfg.dtype):
        """z+ of the step on route ``impl`` with the model in ``dtype``; the
        caller puts the committed slices back, so every call starts from
        the same state."""
        model.cfg = dataclasses.replace(cfg, attn_impl=impl, ssm_impl=impl, dtype=dtype)
        new, _ = rt.train_step(state, batch, alive)
        model.cfg = cfg
        return park(new["z"])

    def put_back():
        for n in X:
            X[n][active].copy_(xa[n])
            Y[n][active].copy_(ya[n])

    def worst_gap(got, want):
        return max((normwise_gap(got[n].cuda(), want[n].cuda()), n) for n in want)

    # (i), (ii) on the kernel route.
    x_other = {n: t[other].cpu() for n, t in X.items()}
    y_other = {n: t[other].cpu() for n, t in Y.items()}
    z1 = step("kernel", alive1)
    same = all(torch.equal(X[n][other].cpu(), x_other[n]) and torch.equal(Y[n][other].cpu(), y_other[n])
               for n in X)
    if not same:
        raise AssertionError(f"{label} (i): the agent that did not commit moved")
    del x_other, y_other
    off, worst = 0.0, (0.0, "")
    eps32 = torch.finfo(torch.float32).eps
    chunk = 1 << 26  # elements a pass: bounds the f64 temporaries
    for n in Z:
        flat = [t.cuda().reshape(-1)
                for t in (X[n][active], xa[n], Y[n][active], ya[n], Z[n], z1[n])]
        for i in range(0, flat[0].numel(), chunk):
            xn, xo, yn, yo, zo, zn = (t[i:i + chunk].double() for t in flat)
            want = zo + ((xn - xo) - (yn - yo) / rho) / A
            err = (zn - want).abs()
            terms = (xn.abs() + xo.abs() + (yn.abs() + yo.abs()) / rho) / A
            u = ulp(want, z1[n].dtype)
            worst = max(worst, ((err / (2 * u + 4 * eps32 * terms)).max().item(), n))
            off = max(off, (err / u).max().item())
            del xn, xo, yn, yo, zo, zn, want, err, terms, u
    if worst[0] > 1:
        raise AssertionError(f"{label} (ii): z+ off the recomputed update by {worst[0]:.2f} x "
                             f"its rounding bound at {worst[1]}")
    log(f"[{label}] (i) the agent that did not commit kept x and y bit for bit; (ii) z+ vs "
        f"z + (1/A) sum mask delta recomputed in f64: {worst[0]:.3f} of the rounding bound "
        f"(worst at {worst[1]}; {off:.3f} ulps of z+ at most)")
    put_back()

    # The spread of two correct computations: the plain route, model in bf16
    # and widened to f32 (the state stays as stored).
    z_plain = step("plain", alive1)
    put_back()
    dtypes = param_dtypes(model)
    model.to(torch.float32)
    if host:
        # z+ of an incremental step reads the committing agent's x and y
        # only (the other agent's x feeds its forward's metrics): here both
        # agents share those slices, and the whole x and y wait on the host.
        whole = {key: {n: t.cpu() for n, t in d.items()} for key, d in (("x", X), ("y", Y))}
        for d, mine in ((X, xa), (Y, ya)):
            for n in d:
                d[n] = mine[n].to("cuda", copy=True)[None].expand(A, *mine[n].shape)
    z_plain32 = step("plain", alive1, "float32")
    if host:
        for key, d in (("x", X), ("y", Y)):
            for n in d:
                d[n] = whole[key][n].cuda()
        del whole
    put_back()
    restore_dtypes(model, dtypes)
    spread, spread_at = worst_gap(z_plain, z_plain32)
    bound = 2 * spread
    del z_plain32
    gap_iv, at_iv = worst_gap(z1, z_plain)
    del z_plain
    z2 = step("kernel", alive2)
    put_back()
    gap_iii, at_iii = worst_gap(z2, z1)
    del z1, z2
    log(f"[{label}] spread of correct paths: z+ of the plain route in bf16 vs in f32 "
        f"{spread:.3e} at {spread_at}; bound 2 x spread = {bound:.3e}; (iii) z+ under alive "
        f"masks {alive1.astype(int).tolist()} vs {alive2.astype(int).tolist()}: {gap_iii:.3e} at "
        f"{at_iii}; (iv) kernel vs plain route: {gap_iv:.3e} at {at_iv}")
    if gap_iii > bound or gap_iv > bound:
        raise AssertionError(f"{label} (iii)/(iv) beyond the spread bound {bound:.3e}")
    result.update(z_rounding_share=worst[0], spread=spread, bound=bound, gap_straggler=gap_iii,
                  gap_kernel_plain=gap_iv)
    del rt, state, X, Y, Z, xa, ya, model
    torch.cuda.empty_cache()
    return result


def remat_comparison(label, model, cfg, batch, per_pass, steps=2):
    """``remat="dots"`` against ``"full"`` on one model: the loss and every
    parameter's gradient of one loss + backward from the same weights and
    batch (bit for bit expected: the saved products are the forward's own,
    and the recomputation repeats the rest; the worst normwise gap is
    printed beside and held at TRAIN_TOL of the model's dtype), with each kernel's launches (``per_pass``, the same
    under both policies: "dots" recomputes the kernels' outputs), then
    ``steps`` Adam steps under each from one optimizer state, with their
    warm step seconds and peak device memory."""
    from repro_torch.distributed import PlainRuntime

    got = {}
    for remat in ("dots", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads, launches, seconds = loss_and_grads(model, c, batch)
        want = {k: 0 for k in launches}
        want.update(per_pass)
        if launches != want:
            raise AssertionError(f"{label} remat {remat}: launches {launches}, want {want}")
        got[remat] = (loss, grads)
        log(f"[{label}] remat {remat}: loss {loss.item():.6f}, loss + backward {seconds:.3f} s, "
            f"launches {launches}")
    (ld, gd), (lf, gf) = got.pop("dots"), got.pop("full")
    same = bool(torch.equal(ld, lf)) and all(torch.equal(gd[n], gf[n]) for n in gf)
    gap, at = grad_gap(gd, gf)
    loss_gap = abs(ld.item() - lf.item()) / abs(lf.item())
    del gd, gf
    result = dict(bit_for_bit=same, loss_gap=loss_gap, grad_gap=gap, grad_gap_at=at)
    log(f"[{label}] remat dots vs full, one loss + backward: bit for bit {same}; loss "
        f"relative gap {loss_gap:.3e}, worst parameter gradient gap {gap:.3e} at {at}")
    tol = TRAIN_TOL[cfg.dtype]["grad"]
    if not np.isfinite(ld.item()) or gap > tol:
        raise AssertionError(f"{label}: remat dots vs full beyond {tol:.0e}")
    rt = PlainRuntime(model, lr=3e-4)
    state = rt.init_state()
    for remat in ("dots", "full"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for _ in range(steps + 1):  # the first step warms the policy's path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = rt.train_step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not np.isfinite(metrics["loss"].item()):
            raise AssertionError(f"{label} remat {remat}: loss {metrics['loss'].item()}")
        warm = float(np.median(step_s[1:]))
        log(f"[{label}] remat {remat}: {steps} warm Adam steps {json.dumps(step_s[1:])} s "
            f"(median {warm:.4f} s), peak device memory {peak / 2**30:.2f} GiB")
        result[remat] = dict(warm_step_s=warm, step_s=step_s[1:], peak_bytes=peak)
    model.cfg = cfg
    del rt, state
    torch.cuda.empty_cache()
    return result


def phase_train_whisper(steps=5):
    """whisper-medium at full size (24 + 24 layers), bf16, batch 8 x 448
    tokens with the launcher's 1,500 stand-in frames a row, remat "full":
    ``steps`` Adam steps through the training entry point (no kernel
    launches: Whisper's attention is the plain path), peak memory and a
    profile of one warm step; then ``remat="dots"`` against ``"full"``
    (`remat_comparison`) on Whisper and on qwen3-0.6b at [train-qwen3]'s
    batch 4 x 2048, where K3 and its backward run under both policies.
    "none" is not run for Whisper: its saved encoder attention
    probabilities alone (f32, 8 x 16 x 1500 x 1500 a layer, 24 layers)
    take 27.6 GB, and the whole step was reckoned past 70 GiB."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import PlainRuntime
    from repro_torch.launch import train
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config("whisper-medium"), remat="full")
    B, S = 8, 448
    counters = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = train.main(["--arch", "whisper-medium", "--batch", str(B), "--seq", str(S),
                      "--steps", str(steps), "--log-every", "1", "--seed", "0"])
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise AssertionError(f"train-whisper: launches {launches}, want none")
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train-whisper: losses {losses}")
    model = run["model"]
    held = sum(p.numel() for p in model.parameters())
    warm = float(np.median(run["step_s"][1:]))
    log(f"[train-whisper] {cfg.name}: {held / 1e9:.3f} B parameters held ({cfg.param_count():,} "
        f"by the reference's count, which leaves out dec_pos), batch {B} x {S} + "
        f"{cfg.encoder_positions} frames, remat {cfg.remat}; {steps} steps: losses "
        f"{json.dumps(losses)}, step s {json.dumps(run['step_s'])}, warm step {warm:.4f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB, no kernel launches")
    batch = lm_batch(cfg.vocab, B, S, seed=1)
    batch["extra_embeds"] = stub_embeds(cfg, B, "cuda")
    rt, state = PlainRuntime(model, lr=3e-4), run["state"]
    prof = profile_share(lambda: rt.train_step(state, batch), top=8)
    log("[train-whisper] profile of one warm step: " + json.dumps(prof))
    result = dict(losses=losses, warm_step_s=warm, peak_bytes=peak, profile=prof)
    del run, rt, state
    torch.cuda.empty_cache()
    result["remat"] = remat_comparison("train-whisper", model, cfg, batch, {})
    del model, batch
    torch.cuda.empty_cache()

    qcfg = dataclasses.replace(get_config("qwen3-0.6b"), remat="full")
    L = qcfg.n_layers
    qwen = get_model(qcfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    qwen.requires_grad_(True)
    per_pass = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    result["qwen3_remat"] = remat_comparison("train-qwen3 remat", qwen, qcfg,
                                             lm_batch(qcfg.vocab, 4, 2048), per_pass)
    del qwen
    torch.cuda.empty_cache()
    return result


def phase_whisper():
    """whisper-medium at full size in bf16, random weights from seed 0:
    serve-whisper (batch 8, 1,500 stand-in frames, prompt 192, 64 new
    tokens; no kernel launches), train-whisper (`phase_train_whisper`) and
    consensus-whisper (phase 10c at seq 448 with frames; no kernel
    launches, so check (iv) compares the plain route with itself)."""
    return {
        "serve-whisper": phase_serve("serve-whisper", "whisper-medium", 8, 192, 64, {}, ()),
        "train-whisper": phase_train_whisper(),
        "consensus-whisper": phase_consensus("consensus-whisper", "whisper-medium", {}, {},
                                             seq=448),
    }


def witness_verdict(readings, factor: float = WITNESS_FACTOR) -> dict:
    """The witness rule as a function of its readings: {body: passes}. A
    kernel body passes when, on every seed, both of its gaps to the f64
    witness (the worst leaf and normwise over all parameters) are within
    ``factor`` times the plain bf16 path's. ``readings``: one dict a seed,
    {"gaps": {"plain": {"leaf": x, "normwise": y}, body: {...}, ...}}."""
    bodies = sorted({b for r in readings for b in r["gaps"]} - {"plain"})
    return {
        body: bool(readings) and all(
            r["gaps"][body][k] <= factor * r["gaps"]["plain"][k]
            for r in readings for k in ("leaf", "normwise")
        )
        for body in bodies
    }


@contextlib.contextmanager
def forced_ssd_body(body):
    """`ops.ssd_scan` on ``body`` ("cuda_cores" or "tensor_cores") whatever
    `ssd_body` would pick, for the witness's readings only (None: the
    pick stands)."""
    import repro_torch.kernels.ops as ops_mod

    pick = ops_mod.ssd_body
    if body is not None:
        ops_mod.ssd_body = lambda *args: body
    try:
        yield
    finally:
        ops_mod.ssd_body = pick


def params_gap(got: dict, want: dict) -> float:
    """Normwise over all parameters: max |got - want| over every leaf,
    over max |want| over every leaf."""
    return (max(max_err(got[n], w) for n, w in want.items())
            / max(w.abs().max().item() for w in want.values()))


def phase_train_mamba2_witness(seeds=(0, 1), B=2, S=4096):
    """The bf16 training bound of mamba2-1.3b, decided against an f64
    witness (ROADMAP Queue 3 item 1). For each seed (weights and batch),
    at full width, ``B`` x ``S``, remat "full": the plain path in float64
    from the bf16 weights widened exactly (the witness), then three bf16
    paths from the same weights: plain (``ssd_chunked``), K4's CUDA-core
    body and its tensor-core body (each forced for its reading), each
    read against the witness as the worst leaf's gap (``grad_gap``) and
    normwise over all parameters (``params_gap``), with the token NLLs
    normwise beside them. A body passes when both readings are within
    WITNESS_FACTOR x the plain path's on every seed (`witness_verdict`).
    Asserted: the CUDA-core body against plain bf16 at TRAIN_TOL (as
    [train-mamba2] held it before the witness), and the witness rule for
    every body that `ssd_body` sends the bf16 training forward to. The
    layer count is cut, for every path alike, only if the witness's
    reckoned memory does not fit the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_body
    from repro_torch.models import get_model

    full = dataclasses.replace(get_config("mamba2-1.3b"), remat="full")
    # The witness's reckoned bytes: f64 parameters and gradients, the saved
    # layer inputs (remat "full") and the logits with their log-softmax.
    total = torch.cuda.get_device_properties(0).total_memory
    L = full.n_layers
    while True:
        reckoned = (16 * dataclasses.replace(full, n_layers=L).param_count()
                    + 8 * L * B * S * full.d_model + 3 * 8 * B * S * full.vocab)
        if reckoned <= 0.7 * total or L == 1:
            break
        L //= 2
    cfg = dataclasses.replace(full, n_layers=L)
    log(f"[train-mamba2 witness] {cfg.name}, batch {B} x {S}, remat {cfg.remat}: the f64 "
        f"witness reckoned at {reckoned / 2**30:.1f} GiB of {total / 2**30:.1f} GiB"
        + ("" if L == full.n_layers else f"; depth cut {full.n_layers} -> {L} layers for "
           "every path"))
    conv = {"causal_conv_silu": 2 * L, "causal_conv_silu_bwd": L}
    want_launches = {"plain": {}, "cuda_cores": {"ssd_scan": 2 * L, **conv},
                     "tensor_cores": {"ssd_scan_tc": 2 * L, "ssd_scan_bwd_tc": L, **conv}}
    readings = []
    for seed in seeds:
        model = get_model(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(seed))
        model.requires_grad_(True)
        batch = lm_batch(cfg.vocab, B, S, seed)
        dtypes = param_dtypes(model)
        model.to(torch.float64)  # every bf16 and f32 weight, exactly
        c64 = dataclasses.replace(cfg, ssm_impl="plain", dtype="float64")
        torch.cuda.reset_peak_memory_stats()
        nll64 = token_nll(model, c64, batch)
        loss64, g64, _, sec64 = loss_and_grads(model, c64, batch)
        peak64 = torch.cuda.max_memory_allocated()
        restore_dtypes(model, dtypes)
        reading = dict(seed=seed, witness=dict(loss=loss64.item(), seconds=sec64,
                                               peak_gib=peak64 / 2**30), gaps={})
        g_plain = None
        for path, impl in (("plain", "plain"), ("cuda_cores", "kernel"),
                           ("tensor_cores", "kernel")):
            c = dataclasses.replace(cfg, ssm_impl=impl)
            with forced_ssd_body(None if path == "plain" else path):
                nll = token_nll(model, c, batch)
                loss, g, launches, sec = loss_and_grads(model, c, batch)
            want = {k: 0 for k in launches}
            want.update(want_launches[path])
            if launches != want:
                raise AssertionError(f"witness {path}: launches {launches}, want {want}")
            leaf, at = grad_gap(g, g64)
            gaps = dict(leaf=leaf, leaf_at=at, normwise=params_gap(g, g64),
                        token_nll=normwise_gap(nll, nll64),
                        loss=abs(loss.item() - loss64.item()) / abs(loss64.item()),
                        seconds=sec)
            if path == "plain":
                g_plain, loss_plain = g, loss
            else:
                # The old reading of each body: against plain bf16.
                gaps["vs_plain_bf16_leaf"], gaps["vs_plain_bf16_at"] = grad_gap(g, g_plain)
                gaps["vs_plain_bf16_loss"] = (abs(loss.item() - loss_plain.item())
                                              / abs(loss_plain.item()))
                del g
            reading["gaps"][path] = gaps
            del nll
        del g_plain, g64, nll64
        cc = reading["gaps"]["cuda_cores"]
        tol = TRAIN_TOL["bfloat16"]
        if not (cc["vs_plain_bf16_leaf"] <= tol["grad"] and cc["vs_plain_bf16_loss"] <= tol["loss"]):
            raise AssertionError(f"witness seed {seed}: the CUDA-core body vs plain bf16 "
                                 f"{cc['vs_plain_bf16_leaf']:.3e} (tolerance {tol['grad']:.0e}), "
                                 f"loss {cc['vs_plain_bf16_loss']:.3e} ({tol['loss']:.0e})")
        g = reading["gaps"]
        log(f"[train-mamba2 witness] seed {seed}: f64 loss {loss64.item():.6f} "
            f"({sec64:.2f} s, peak {peak64 / 2**30:.2f} GiB); against it, worst leaf / "
            f"normwise / token NLLs normwise: "
            + "; ".join(f"e_{p} {g[p]['leaf']:.3e} at {g[p]['leaf_at']} / {g[p]['normwise']:.3e}"
                        f" / {g[p]['token_nll']:.3e}" for p in g)
            + f"; vs plain bf16, worst leaf: CUDA-core body {cc['vs_plain_bf16_leaf']:.3e} at "
            f"{cc['vs_plain_bf16_at']} (tolerance {tol['grad']:.0e}), tensor-core body "
            f"{g['tensor_cores']['vs_plain_bf16_leaf']:.3e}")
        log("[train-mamba2 witness] reading " + json.dumps(reading))
        readings.append(reading)
        del model, batch
        torch.cuda.empty_cache()
    verdict = witness_verdict(readings)
    # The body that the bf16 training forward takes (mamba2-1.3b's heads).
    x = torch.empty((1, 1, 1, 64), dtype=torch.bfloat16, device="cuda")
    bm = torch.empty((1, 1, 128), dtype=torch.bfloat16, device="cuda")
    trained = ssd_body(x, bm, bm, cfg.ssm_chunk)
    log(f"[train-mamba2 witness] verdict (each reading within {WITNESS_FACTOR:g} x e_plain on "
        f"seeds {list(seeds)}): {json.dumps(verdict)}; the bf16 training forward runs the "
        f"{trained} body")
    if not verdict[trained]:
        raise AssertionError(f"witness: the {trained} body that training runs fails the rule")
    return dict(readings=readings, verdict=verdict, trained_body=trained, n_layers=L)


def phase_card_vs_cpu_train():
    """The mamba2 and whisper smoke configs in f32: 3 training steps on the
    card (K4 for mamba2; no kernel for whisper, whose batches carry random
    frames) against the same steps on the CPU (plain versions), same
    weights and batches; losses (relative) and final parameters
    (normwise: Adam moves an element whose f32 gradient is round-off by up
    to lr per step on either side, so 1e-4 at lr 1e-3)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import agent_token_streams, make_lm_batch
    from repro_torch.distributed import PlainRuntime
    from repro_torch.models import get_model

    for arch, kernel in (("mamba2-1.3b", "ssd_scan"), ("whisper-medium", None)):
        cfg = get_smoke_config(arch)
        label = f"{arch.split('-')[0]} smoke"
        cpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        gpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).to("cuda")
        rt_c, rt_g = PlainRuntime(cpu, lr=1e-3), PlainRuntime(gpu, lr=1e-3)
        st_c, st_g = rt_c.init_state(), rt_g.init_state()
        stream = agent_token_streams(1, cfg.vocab, seed=2)[0]
        rng = np.random.default_rng(3)
        counters = reset_launches()
        worst = 0.0
        for step in range(3):
            batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(stream, 2, 96).items()}
            if cfg.modality == "audio_stub":
                batch["extra_embeds"] = torch.from_numpy(rng.standard_normal(
                    (2, cfg.encoder_positions, cfg.d_model)).astype(np.float32))
            st_c, m_c = rt_c.train_step(st_c, batch)
            st_g, m_g = rt_g.train_step(st_g, {k: v.cuda() for k, v in batch.items()})
            for key in ("loss", "grad_norm"):
                gap = abs(m_g[key].item() - m_c[key].item()) / abs(m_c[key].item())
                worst = max(worst, gap)
                if gap > 1e-5:
                    raise AssertionError(f"{label} step {step} {key}: gap {gap:.3e} > 1e-5")
        launches = read_launches(counters)
        if kernel is not None and launches[kernel] == 0:
            raise AssertionError(f"{label}: the card run launched no {kernel}")
        if kernel is None and any(launches.values()):
            raise AssertionError(f"{label}: launches {launches}, want none")
        pgap = max(
            hold(f"{label} {n}", pg.detach(), pc.detach().cuda(), CARD_VS_CPU_TOL)
            for (n, pg), (_, pc) in zip(gpu.named_parameters(), cpu.named_parameters())
        )
        log(f"[card-vs-cpu] {label}, 3 training steps (f32): launches {launches}, worst "
            f"loss/grad-norm relative gap {worst:.3e} (tolerance 1e-5), worst parameter "
            f"normwise gap {pgap:.3e} (tolerance {CARD_VS_CPU_TOL:.0e})")
        del gpu, cpu, rt_g, rt_c, st_g, st_c
        torch.cuda.empty_cache()


def phase_card_vs_cpu():
    """The port on the card (kernels) against the port on the CPU (plain
    versions), same weights, prefill then 3 teacher-forced decode steps."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import get_model

    cases = {
        "qwen3-0.6b (2 layers, f32)": (
            dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2, dtype="float32"), 1, 256,
        ),
        # head dim 64, the smallest K3 takes (the smoke config's is 32)
        "recurrentgemma smoke (hd 64)": (
            dataclasses.replace(get_smoke_config("recurrentgemma-9b"), head_dim=64), 2, 96,
        ),
        # 1,500 random frames; Whisper launches no kernel
        "whisper-medium (2 + 2 layers, f32)": (
            dataclasses.replace(get_config("whisper-medium"), n_layers=2, encoder_layers=2,
                                dtype="float32"), 1, 128,
        ),
    }
    for label, (cfg, B, S) in cases.items():
        cpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        gpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).to("cuda")
        rng = np.random.default_rng(2)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
        kw_c = {}
        if cfg.modality == "audio_stub":
            kw_c["extra_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder_positions, cfg.d_model)).astype(np.float32))
        kw_g = {k: v.cuda() for k, v in kw_c.items()}
        counters = reset_launches()
        with torch.inference_mode():
            lg, cg = gpu.prefill(tokens.cuda(), extra_slots=3, **kw_g)
            lc, cc = cpu.prefill(tokens, extra_slots=3, **kw_c)
            worst = hold(f"{label} prefill logits", lg, lc.cuda(), CARD_VS_CPU_TOL)
            worst = max(worst, hold_cache(f"{label} prefill", cg, cc, CARD_VS_CPU_TOL))
            for step in range(3):
                tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)))
                lg, cg = gpu.decode_step(cg, tok.cuda())
                lc, cc = cpu.decode_step(cc, tok)
                worst = max(worst, hold(f"{label} decode {step}", lg, lc.cuda(), CARD_VS_CPU_TOL))
            worst = max(worst, hold_cache(f"{label} after decode", cg, cc, CARD_VS_CPU_TOL))
        launches = read_launches(counters)
        kernels = {"dense": ("flash_attention",), "hybrid": ("flash_attention", "rglru_scan"),
                   "audio": ()}[cfg.family]
        for kernel in kernels:
            if launches[kernel] == 0:
                raise AssertionError(f"{label}: the card run launched no {kernel}")
        if not kernels and any(launches.values()):
            raise AssertionError(f"{label}: launches {launches}, want none")
        log(f"[card-vs-cpu] {label}: B {B} S {S}, launches {launches}, worst normwise "
            f"gap {worst:.3e} (tolerance {CARD_VS_CPU_TOL:.0e})")
        del gpu, cg, kw_g
        torch.cuda.empty_cache()


def phase_moe_vlm():
    """The MoE and VLM paths at full width, cut in depth (each cut logged):
    phi3.5-moe served at 16 of 32 layers (batch 4, prompt 2048, 32 new
    tokens; an f32 prefill of 2 layers), mixtral-8x22b at 8 of 56 (batch 1,
    prompt 8192, twice its 4096 window, 16 new tokens), qwen2-vl-72b at 8
    of 80 with its vision stub (batch 2, prompt 2048, 16 new tokens);
    phi3.5-moe trained at 2 layers, plainly and by csI-ADMM.
    K3 launches once a layer in each prefill."""
    out = {
        "serve-phi35": phase_serve("serve-phi35", "phi3.5-moe-42b-a6.6b", 4, 2048, 32,
                                   {"flash_attention": 16}, K3_KERNELS, n_layers=16,
                                   f32_cut_layers=2),
        "serve-mixtral": phase_serve("serve-mixtral", "mixtral-8x22b", 1, 8192, 16,
                                     {"flash_attention": 8}, K3_KERNELS, n_layers=8),
        "serve-qwen2vl": phase_serve("serve-qwen2vl", "qwen2-vl-72b", 2, 2048, 16,
                                     {"flash_attention": 8}, K3_KERNELS, n_layers=8),
        "train-phi35": phase_train_phi35(),
    }
    # Two layers (2.86 B parameters): the incremental run's state waits on
    # the host during the parallel run, and the checks keep their copies
    # there (with both runs' states, or the copies, on the card it ran out
    # of its 80 GB; `phase_consensus` decides from the measured peak).
    out["consensus-phi35"] = phase_consensus(
        "consensus-phi35", "phi3.5-moe-42b-a6.6b", {"flash_attention": 2},
        {"flash_attention_bwd": 2}, n_layers=2)
    return out


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
    phase_analysis()
    rows = phase_kernels()
    rows += phase_attention_kernels()
    phase_attention_scan()
    rows += phase_scan_kernels()
    rows += phase_backward_kernels()
    rows += phase_ssd_kernels()
    rows += phase_conv_kernels()
    launches = phase_fig5()
    phase_fig3_stragglers()
    phase_baselines()
    phase_variants()
    phase_grids()
    phase_fleet()
    phase_sharded()
    phase_async()
    phase_adaptive()
    qwen = phase_serve("serve-qwen3", "qwen3-0.6b", 4, 2048, 32, {"flash_attention": 28},
                       K3_KERNELS)
    # recurrentgemma-9b: 12 attention layers (K3) and 26 recurrent (K5).
    rg = phase_serve("serve-rg", "recurrentgemma-9b", 2, 2048, 16,
                     {"flash_attention": 12, "rglru_scan": 26}, K5_KERNELS + K3_KERNELS)
    # granite-4.0-h-micro: K3 once a layer of its 4 attention layers, the
    # conv + SiLU kernel once a layer of its 36 Mamba layers; their prefill
    # runs `ssd_chunked`, as mamba2's does.
    phase_serve("serve-granite", "granite-4.0-h-micro", 2, 8192, 32,
                {"flash_attention": 4, "causal_conv_silu": 36}, K3_KERNELS)
    mamba = phase_train_mamba2()
    phase_train_mamba2_witness()
    qwen_train = phase_train_qwen3()
    rg_train = phase_train_rg()
    phase_train_granite()
    phase_consensus("consensus-mamba2", "mamba2-1.3b",
                    {"ssd_scan_tc": 48, "causal_conv_silu": 48},
                    {"ssd_scan_bwd_tc": 48, "causal_conv_silu_bwd": 48})
    phase_consensus("consensus-qwen3", "qwen3-0.6b", {"flash_attention": 28},
                    {"flash_attention_bwd": 28})
    phase_moe_vlm()
    phase_whisper()
    phase_card_vs_cpu()
    phase_card_vs_cpu_train()

    launches["flash_attention"] = qwen["launches"]["flash_attention"]
    launches["rglru_scan"] = rg["launches"]["rglru_scan"]
    launches["ssd_scan"] = mamba["launches_per_step"]
    launches["flash_attention_bwd"] = qwen_train["launches_per_step"]["flash_attention_bwd"]
    launches["rglru_scan_bwd"] = rg_train["launches_per_step"]["rglru_scan_bwd"]
    launches["ssd_scan_bwd"] = mamba["bwd_launches_per_step"]
    launches["causal_conv_silu"] = mamba["conv_launches_per_step"]
    launches["causal_conv_silu_bwd"] = mamba["conv_bwd_launches_per_step"]
    # Each kernel's row in the summary: its main path's shape and dtype.
    main_shape = {
        "coded_admm_update": ("fig5_step", "float64"),
        "coded_combine": ("fig5_step", "float64"),
        "flash_attention": ("qwen3_step", "bfloat16"),
        "rglru_scan": ("rg_step", "float32"),
        "ssd_scan": ("train_step_tc", "bfloat16"),
        "flash_attention_bwd": ("qwen3_train", "bfloat16"),
        "rglru_scan_bwd": ("rg_train", "float32"),
        "ssd_scan_bwd": ("cells_step", "bfloat16"),
        "causal_conv_silu": ("cells_step", "bfloat16"),
        "causal_conv_silu_bwd": ("cells_step", "bfloat16"),
    }
    main_row = {
        r["name"]: r for r in rows if (r["shape"], r["dtype"]) == main_shape[r["name"]]
    }
    kernels = [
        dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name],
            **{k: main_row[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "share_of_bound", "achieved_rate",
                "rate_unit", "shape", "dtype",
            )},
        )
        for name in SOURCES
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
