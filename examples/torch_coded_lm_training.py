"""csI-ADMM as a training feature on the PyTorch port: decentralized LM training.

The twin of `examples/coded_lm_training.py` on `repro_torch`. Two
simulated agents with disjoint token streams train a shared transformer LM
by consensus: each agent's mini-batch gradient is computed over K=4 coded
ECN partitions (cyclic (4,3) MDS code, S=1 straggler per agent per step,
sampled randomly), and the consensus token z is the served model. On a
CUDA device the attention runs through the flash-attention kernels
(forward and backward).

Default is a ~20M-parameter model; ``--params 100m`` selects a
~100M-parameter config.

  PYTHONPATH=src python examples/torch_coded_lm_training.py --steps 200 [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.data import agent_token_streams, make_lm_batch
from repro_torch.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.models import ModelConfig, get_model

SIZES = {
    # ~20M: d=256, L=4, F=1024, vocab=8192
    "20m": dict(d_model=256, n_layers=4, d_ff=1024, vocab=8192,
                n_heads=4, n_kv_heads=2),
    # ~100M: d=640, L=10, F=2560, vocab=50304
    "100m": dict(d_model=640, n_layers=10, d_ff=2560, vocab=50304,
                 n_heads=10, n_kv_heads=5),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", choices=SIZES, default="20m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-rows", type=int, default=2,
                    help="rows per (agent, ecn, partition-copy)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def model_config(params: str) -> ModelConfig:
    s = SIZES[params]
    return ModelConfig(
        name=f"consensus-lm-{params}", family="dense",
        head_dim=s["d_model"] // s["n_heads"], qk_norm=True,
        dtype="float32", **s,
    )


def train(model, args):
    """Consensus training of ``model`` (its weights are z's start) as the
    original runs it; returns the per-step losses."""
    cfg = model.cfg
    print(f"model: {cfg.param_count():,} params "
          f"(d={cfg.d_model}, L={cfg.n_layers}, V={cfg.vocab})")

    A, K, S = args.agents, 4, 1
    # parallel (PW-ADMM-style) mode: every agent commits each step — the
    # beyond-paper variant that actually utilizes a synchronous machine;
    # pass mode="incremental" for the paper-faithful token traversal.
    ccfg = ConsensusConfig(
        n_agents=A, K=K, S=S, scheme="cyclic", mode="parallel",
        rho=1.0, c_tau=1.0, c_gamma=0.05,
    )
    rt = ConsensusRuntime(model, ccfg)
    code = ccfg.code()
    sup = [code.support(j) for j in range(K)]

    state = rt.init_state()
    streams = agent_token_streams(A, cfg.vocab, seed=0)
    rng = np.random.default_rng(1)
    dev = model.device

    losses = []
    for k in range(args.steps):
        # coded allocation: agent a draws K fresh partitions; partition t is
        # laid out on every ECN whose (cyclic) support covers t.
        rows = []
        for a in range(A):
            parts = [make_lm_batch(streams[a], args.batch_rows, args.seq)
                     for _ in range(K)]
            for j in range(K):
                for t in sup[j]:
                    rows.append(parts[t])
        batch = {key: torch.from_numpy(np.concatenate([r[key] for r in rows])).to(dev)
                 for key in rows[0]}
        alive = np.ones((A, K), bool)
        for a in range(A):  # one random straggler per agent per step
            alive[a, rng.integers(K)] = False
        state, metrics = rt.train_step(state, batch, alive)
        losses.append(float(metrics["loss"]))
        if k % args.log_every == 0 or k == args.steps - 1:
            print(f"step {k:4d}  loss {losses[-1]:.4f}  "
                  f"consensus residual {float(metrics['consensus_residual']):.3e}",
                  flush=True)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nmean loss: first 10 steps {first:.4f} -> last 10 steps {last:.4f}")
    if not last < first:
        raise SystemExit("consensus LM training should reduce the loss")
    print("OK — decentralized coded-gradient LM training converges.")
    return losses


def main(argv=None):
    args = parse_args(argv)
    gen = torch.Generator(device=args.device).manual_seed(0)
    model = get_model(model_config(args.params), device=args.device, generator=gen)
    return train(model, args)


if __name__ == "__main__":
    main()
