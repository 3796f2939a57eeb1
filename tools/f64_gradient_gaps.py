#!/usr/bin/env python
"""Print the normwise gaps of two exact f64 gradient checks of the port,
under three thread settings, to show whether the order of threaded sums
moves them (ROADMAP.md Queue 3, item 4):

- flash attention's exact backward (`repro_torch.kernels.ref.
  flash_attention_bwd_ref`) against ``jax.vjp`` of the reference's oracle,
  on the cases of ``tests/test_torch_flash_bwd.py`` (bound 1e-8 there);
- Whisper's loss and gradients against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` under each ``remat``, with and without loss
  weights, as ``tests/test_torch_whisper.py`` holds them (bound 1e-9).

Each setting runs in a process of its own: the default thread count,
``torch.set_num_threads(1)``, and ``torch.use_deterministic_algorithms
(True)``; each repeats its flash-attention cases ``--reps`` times and
prints how many distinct readings it saw.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/f64_gradient_gaps.py
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(setting: str, reps: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_flash_bwd as fb
    import test_torch_whisper as tw

    import repro.kernels.ref as r_ref
    from repro_torch.kernels import ref

    if setting == "one-thread":
        torch.set_num_threads(1)
    elif setting == "deterministic":
        torch.use_deterministic_algorithms(True)
    r_ref.jnp = fb._Jnp64()
    for mod in (tw.r_whisper, tw.r_layers, tw.r_losses):
        mod.jnp = tw._Jnp64()

    readings = []
    for _ in range(reps):
        row = []
        for B, H, KV, S, hd, window in fb.ROUNDING_CASES:
            rng = np.random.default_rng(S * H + hd)
            qn, don = (rng.standard_normal((B, H, S, hd)) for _ in range(2))
            kn, vn = (rng.standard_normal((B, KV, S, hd)) for _ in range(2))
            q, k, v, do = (fb._bf16_round(torch.from_numpy(a)) for a in (qn, kn, vn, don))
            o, lse = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                             return_lse=True)
            exact = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True, window)
            _, vjp = jax.vjp(
                lambda q_, k_, v_: r_ref.flash_attention_ref(q_, k_, v_, causal=True,
                                                             window=window),
                *(jnp.asarray(t.numpy()) for t in (q, k, v)),
            )
            want = vjp(jnp.asarray(do.numpy()))
            row.append(max(fb._normwise(w, np.asarray(r)) for w, r in zip(exact, want)))
        readings.append(tuple(row))
    print(f"{setting} ({torch.get_num_threads()} threads): flash attention bwd vs jax.vjp, "
          f"worst of q/k/v per case {[f'{g:.3e}' for g in readings[0]]}, "
          f"{len(set(readings))} distinct reading(s) in {reps} repetitions")

    for remat in ("none", "full", "dots"):
        for weights in (False, True):
            model_r, params, model_t = tw._pair(dtype="float64", remat=remat)
            model_t.requires_grad_(True)
            cfg = model_t.cfg
            rng = np.random.default_rng(5)
            batch = {
                "tokens": rng.integers(0, cfg.vocab, (2, 40), dtype=np.int32),
                "labels": rng.integers(0, cfg.vocab, (2, 40), dtype=np.int32),
                "extra_embeds": tw._frames(rng, 2, cfg, np.float64),
            }
            batch["labels"][0, :5] = -100
            if weights:
                batch["loss_weights"] = rng.random(2)
            (loss_r, _), grads_r = jax.value_and_grad(model_r.loss, has_aux=True)(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
            loss_t, _ = model_t.loss({k: torch.from_numpy(v) for k, v in batch.items()})
            loss_t.backward()
            got = tw._flat(tw.flat_to_reference(
                model_t, {n: p.grad for n, p in model_t.named_parameters()}))
            gap = max(tw._normwise(got[n], w) for n, w in tw._flat(grads_r).items())
            rel = abs(loss_t.item() - float(loss_r)) / abs(float(loss_r))
            print(f"{setting}: whisper remat {remat} weights {weights}: loss relative "
                  f"{rel:.3e}, worst gradient normwise {gap:.3e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if args.setting:
        measure(args.setting, args.reps)
        return
    for setting in ("default", "one-thread", "deterministic"):
        subprocess.run([sys.executable, __file__, "--setting", setting,
                        "--reps", str(args.reps)], check=True)


if __name__ == "__main__":
    main()
