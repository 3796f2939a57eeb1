"""Model construction for the ported families (port of
`repro.models.registry`), and the port's own ``granite`` family.

``get_model(cfg, device=..., generator=...)`` returns the family's
``nn.Module`` with its weights drawn on ``device`` from ``generator``
(a fresh ``torch.Generator`` seeded 0 when None). Every model has
``prefill(tokens, extra_slots=0)`` (Whisper's takes its frames as
``extra_embeds``), ``decode_step(cache, token)`` and
``init_cache(B, seq_len)``, and trains: ``forward(tokens)`` and
``loss(batch)``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .config import ModelConfig
from .granite import Granite
from .mamba2 import Mamba2
from .rglru import RecurrentGemma
from .transformer import Transformer
from .whisper import Whisper

__all__ = ["FAMILIES", "get_model", "empty_model", "resolve_device"]

FAMILIES = {
    "dense": Transformer,
    "moe": Transformer,
    "vlm": Transformer,
    "ssm": Mamba2,
    "hybrid": RecurrentGemma,
    "audio": Whisper,
    "granite": Granite,  # the port's own family (no counterpart in the reference)
}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device, or a clear error when it names a card that is absent:
    the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions on the CPU"
        )
    return device


def empty_model(cfg: ModelConfig, device: Union[str, torch.device] = "cuda"):
    """The family's module with uninitialised weights on ``device``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"unknown model family {cfg.family!r} (known: {sorted(FAMILIES)})"
        )
    return FAMILIES[cfg.family](cfg, resolve_device(device))


def get_model(
    cfg: ModelConfig,
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
):
    """The family's module with random weights at the reference's scales,
    drawn on ``device`` one tensor at a time."""
    model = empty_model(cfg, device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return model.init_(generator)
