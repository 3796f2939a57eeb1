"""Training launcher (port of `repro.launch.train`, plain mode).

Runs real Adam steps (`repro_torch.distributed.PlainRuntime`) on a model
with random weights from ``--seed`` and the synthetic token stream of
`repro_torch.data` (seed ``--seed``), on ``--device`` (default ``cuda``;
without a card pass ``--device cpu``). Layers are checkpointed
(``remat="full"``: only layer inputs are kept and each layer is
recomputed in the backward pass, which a full-size model on one card
needs). ``--mode consensus`` (the paper's csI-ADMM across agents) is not
ported yet.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --smoke --device cpu --steps 5 --batch 2 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --batch 2 --seq 4096 --steps 5
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import save_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import agent_token_streams, make_lm_batch
from repro_torch.distributed import PlainRuntime
from repro_torch.models import get_model, to_reference
from repro_torch.models.registry import resolve_device

__all__ = ["run_plain", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_plain(model, args) -> dict:
    rt = PlainRuntime(model, lr=args.lr)
    state = rt.init_state()
    stream = agent_token_streams(1, model.cfg.vocab, seed=args.seed)[0]
    dev = model.device
    losses, step_s = [], []
    for k in range(args.steps):
        batch = {
            key: torch.from_numpy(v).to(dev)
            for key, v in make_lm_batch(stream, args.batch, args.seq).items()
        }
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
    return {"losses": losses, "step_s": step_s, "state": state, "model": model}


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
    args = ap.parse_args(argv)

    if args.mode == "consensus":
        raise NotImplementedError(
            "--mode consensus (ConsensusRuntime, the paper's csI-ADMM over "
            "agents) is not ported yet: ROADMAP.md Queue 1, item 15"
        )
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, remat="full")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device, generator=gen)
    print(
        f"training {args.arch} ({'smoke' if args.smoke else 'full'}) on "
        f"{device} mode={args.mode} remat={cfg.remat} params={cfg.param_count():,}"
    )
    out = run_plain(model, args)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss: {first:.4f} -> {last:.4f}")
    return out


if __name__ == "__main__":
    main()
