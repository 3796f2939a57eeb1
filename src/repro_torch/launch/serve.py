"""Serving launcher: batched prefill + greedy decode loop (port of
`repro.launch.serve`).

Builds a model with random weights from a seed, prefills a batch of
random prompts once, then streams greedy decode steps from the KV/state
cache. On the card the prefill runs the hand-written kernels (flash
attention for the transformer families, the RG-LRU scan for the hybrid
one). A vision-stub model (qwen2-vl-72b) gets the reference's stand-in for
its vision encoder's output (`stub_embeds`) in place of its first 16
prompt positions; an audio-stub model (whisper-medium) gets the
reference's stand-in frames for its encoder.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 2048 --new-tokens 32

``--device`` defaults to ``cuda``; without a card pass ``--device cpu``
(with ``--smoke`` for a CPU-sized model).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.registry import resolve_device

__all__ = ["make_prompts", "stub_embeds", "prefill_kwargs", "serve", "main"]

# Positions of the vision stub's stand-in embeddings (the reference's).
VISION_STUB_POSITIONS = 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(
    vocab: int, batch: int, prompt_len: int, seed: int, device
) -> torch.Tensor:
    """Random prompts (batch, prompt_len) int64 from a generator on
    ``device`` seeded ``seed + 1`` (the weights take ``seed``)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(
        0, vocab, (batch, prompt_len), generator=gen, device=device,
        dtype=torch.int64,
    )


def stub_embeds(cfg, batch: int, device) -> Optional[torch.Tensor]:
    """The reference's stand-ins, 0.01 in the model dtype: a vision
    encoder's output (batch, 16, D) for a ``vision_stub`` config, the audio
    frontend's frames (batch, encoder_positions, D) for an ``audio_stub``
    one; None for a text model."""
    if cfg.modality == "vision_stub":
        shape = (batch, VISION_STUB_POSITIONS, cfg.d_model)
    elif cfg.modality == "audio_stub":
        shape = (batch, cfg.encoder_positions, cfg.d_model)
    else:
        return None
    return torch.full(shape, 0.01, dtype=cfg.torch_dtype, device=device)


def prefill_kwargs(cfg, batch: int, device) -> dict:
    """``extra_embeds`` for ``prefill`` when the config has a stub, else
    nothing (the recurrent families' ``prefill`` takes none)."""
    ee = stub_embeds(cfg, batch, device)
    return {} if ee is None else {"extra_embeds": ee}


@torch.inference_mode()
def serve(model, batch: int, prompt_len: int, new_tokens: int, seed: int = 0) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens
    (`make_prompts`) with the model's `stub_embeds`, then decode
    ``new_tokens`` greedily. Returns tokens (batch, new_tokens) on the
    CPU, ``prefill_s`` and ``decode_s_per_tok`` (device-synchronised)."""
    dev = model.device
    prompts = make_prompts(model.cfg.vocab, batch, prompt_len, seed, dev)
    kwargs = prefill_kwargs(model.cfg, batch, dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, extra_slots=new_tokens, **kwargs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out, dim=1).cpu(),
        "prefill_s": t_prefill,
        "decode_s_per_tok": t_decode / max(new_tokens - 1, 1),
    }


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device, generator=gen)
    r = serve(model, args.batch, args.prompt_len, args.new_tokens, args.seed)
    print(
        f"served {cfg.name} on {device} batch={args.batch} "
        f"prompt={args.prompt_len} new={args.new_tokens}: prefill "
        f"{r['prefill_s']:.3f}s, {r['decode_s_per_tok'] * 1000:.1f} ms/token"
    )
    print("first sequence:", r["tokens"][0][:16].tolist(), "...")
    return r


if __name__ == "__main__":
    main()
