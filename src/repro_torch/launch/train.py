"""Training launcher (port of `repro.launch.train`).

Runs real steps on a model with random weights from ``--seed`` and the
synthetic token streams of `repro_torch.data` (seed ``--seed``), on
``--device`` (default ``cuda``; without a card pass ``--device cpu``).
Two modes, as the reference's:

  plain      — Adam (`repro_torch.distributed.PlainRuntime`)
  consensus  — the paper's csI-ADMM across ``--agents`` agents with
               ``--ecns`` coded ECN groups each, ``--stragglers`` of them
               dropped per step (`repro_torch.distributed.ConsensusRuntime`)

Layers are checkpointed (``remat="full"``: only layer inputs are kept and
each layer is recomputed in the backward pass, which a full-size model on
one card needs). The host side (token streams, the coded allocation of
rows, the straggler draws) is numpy, bit for bit the reference's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --smoke --device cpu --steps 5 --batch 2 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --mode consensus --steps 5 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --batch 2 --seq 4096 --steps 5

``--trace PATH`` profiles the two steps after the first (``--steps`` 3 or
more) and writes them to PATH as a Chrome trace (chrome://tracing,
Perfetto), holding the runtime's phase spans (`repro_torch.tracing`:
``plain.forward`` / ``backward`` / ``clip`` / ``adam``,
``consensus.load`` / ``forward`` / ``backward`` / ``update`` / ...)
beside the device's kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import agent_token_streams, make_lm_batch
from repro_torch.distributed import ConsensusConfig, ConsensusRuntime, PlainRuntime
from repro_torch.launch.serve import stub_embeds
from repro_torch.models import get_model, to_reference
from repro_torch.models.params import flat_to_reference
from repro_torch.models.registry import resolve_device

__all__ = ["run_plain", "run_consensus", "consensus_batches", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StepTrace:
    """``--trace``: a profiler over steps 1 and 2, written out after step 2."""

    def __init__(self, path: Optional[str], device: torch.device):
        self.path = path
        self.device = device
        self.prof = None
        if path is not None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)

    def before(self, k: int) -> None:
        if self.prof is not None and k == 1:
            self.prof.start()

    def after(self, k: int) -> None:
        if self.prof is not None and k == 2:
            _sync(self.device)
            self.prof.stop()
            self.prof.export_chrome_trace(self.path)
            print(f"trace of steps 1-2 written to {self.path}", flush=True)


def run_plain(model, args) -> dict:
    rt = PlainRuntime(model, lr=args.lr)
    state = rt.init_state()
    stream = agent_token_streams(1, model.cfg.vocab, seed=args.seed)[0]
    dev = model.device
    losses, step_s = [], []
    trace = _StepTrace(getattr(args, "trace", None), dev)
    for k in range(args.steps):
        trace.before(k)
        batch = {
            key: torch.from_numpy(v).to(dev)
            for key, v in make_lm_batch(stream, args.batch, args.seq).items()
        }
        ee = stub_embeds(model.cfg, args.batch, dev)
        if ee is not None:
            batch["extra_embeds"] = ee
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = rt.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if k % args.log_every == 0 or k == args.steps - 1:
            print(
                f"step {k:5d}  loss {losses[-1]:.4f}  grad_norm "
                f"{float(metrics['grad_norm']):.4f}  ({step_s[-1]:.3f} s)",
                flush=True,
            )
        if args.ckpt_dir and (k + 1) % args.ckpt_every == 0:
            save_step(args.ckpt_dir, k + 1, to_reference(model))
        trace.after(k)
    return {"losses": losses, "step_s": step_s, "state": state, "model": model}


def consensus_batches(args, code, vocab: int, cfg=None):
    """The reference's host side of consensus training, step by step:
    yields (batch of numpy arrays in coded allocation order, (A, K) alive
    mask). Each agent samples K partitions of P rows from its own stream
    and lays partition t out on every ECN whose support holds it; then up
    to S of each agent's ECNs straggle (``default_rng(seed + 7)``).

    For an ``audio_stub`` ``cfg`` the batch also carries the stand-in
    frames, one (encoder_positions, D) block of 0.01 per token row, in
    float32 (the model casts them to its dtype). The reference's launcher
    leaves them out and its Whisper loss then raises ``KeyError``; its
    runtime takes them in the batch, as here."""
    A, K, S = args.agents, args.ecns, args.stragglers
    sup = [code.support(j) for j in range(K)]
    streams = agent_token_streams(A, vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed + 7)
    P_rows = max(args.batch // (A * K * (S + 1)), 1)
    for _ in range(args.steps):
        rows = []
        for a in range(A):
            parts = [make_lm_batch(streams[a], P_rows, args.seq) for _ in range(K)]
            for j in range(K):
                for t in sup[j]:
                    rows.append(parts[t])
        batch = {key: np.concatenate([r[key] for r in rows], axis=0) for key in rows[0]}
        if cfg is not None and cfg.modality == "audio_stub":
            shape = (batch["tokens"].shape[0], cfg.encoder_positions, cfg.d_model)
            batch["extra_embeds"] = np.full(shape, 0.01, np.float32)
        alive = np.ones((A, K), bool)
        for a in range(A):  # straggler event: drop up to S random ECNs
            dead = rng.choice(K, size=S, replace=False)
            alive[a, dead] = False
        yield batch, alive


def run_consensus(model, args) -> dict:
    """csI-ADMM steps of ``model`` (its weights are z's start). Checkpoints
    save z in the reference's layout; at the end the model holds z."""
    ccfg = ConsensusConfig(
        n_agents=args.agents,
        K=args.ecns,
        S=args.stragglers,
        scheme=args.scheme if args.stragglers else "uncoded",
        rho=args.rho,
        c_tau=args.c_tau,
        c_gamma=args.c_gamma,
        mode=args.consensus_mode,
        seed=args.seed,
    )
    rt = ConsensusRuntime(model, ccfg)
    state = rt.init_state()
    dev = model.device
    losses, residuals, step_s, alives = [], [], [], []
    trace = _StepTrace(getattr(args, "trace", None), dev)
    for k, (batch, alive) in enumerate(consensus_batches(
            args, ccfg.code(), model.cfg.vocab, model.cfg)):
        trace.before(k)
        tb = {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = rt.train_step(state, tb, alive)
        losses.append(float(metrics["loss"]))
        residuals.append(float(metrics["consensus_residual"]))
        step_s.append(time.perf_counter() - t0)
        alives.append(alive)
        if k % args.log_every == 0 or k == args.steps - 1:
            print(
                f"step {k:5d}  loss {losses[-1]:.4f}  residual {residuals[-1]:.3e}  "
                f"({step_s[-1]:.3f} s)",
                flush=True,
            )
        if args.ckpt_dir and (k + 1) % args.ckpt_every == 0:
            save_step(args.ckpt_dir, k + 1, flat_to_reference(model, state["z"]))
        trace.after(k)
    rt.load_served(state)
    return {"losses": losses, "residuals": residuals, "step_s": step_s,
            "alive": alives, "state": state, "model": model, "runtime": rt}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mode", choices=("plain", "consensus"), default="plain")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write steps 1 and 2 to PATH as a Chrome trace")
    # consensus
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--ecns", type=int, default=4)
    ap.add_argument("--stragglers", type=int, default=1)
    # NN-scale defaults (the reference's): the x-update's effective step is
    # 1/(rho + tau^k), so c_tau ~ 20 gives ~0.05 at k=1 decaying as
    # 1/sqrt(k) (the paper's least-squares settings diverge on NN losses).
    ap.add_argument("--scheme", default="cyclic")
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--c-tau", type=float, default=20.0)
    ap.add_argument("--c-gamma", type=float, default=0.1)
    ap.add_argument(
        "--consensus-mode", choices=("incremental", "parallel"), default="incremental"
    )
    args = ap.parse_args(argv)
    if args.trace is not None and args.steps < 3:
        ap.error("--trace profiles steps 1 and 2: give --steps 3 or more")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, remat="full")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device, generator=gen)
    print(
        f"training {args.arch} ({'smoke' if args.smoke else 'full'}) on "
        f"{device} mode={args.mode} remat={cfg.remat} params={cfg.param_count():,} "
        f"(the reference's analytic count; the model holds "
        f"{sum(p.numel() for p in model.parameters()):,})"
    )
    out = run_plain(model, args) if args.mode == "plain" else run_consensus(model, args)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss: {first:.4f} -> {last:.4f}")
    return out


if __name__ == "__main__":
    main()
