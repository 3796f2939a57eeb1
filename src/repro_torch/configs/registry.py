"""Architecture registry of the port (``get_config``, ``get_smoke_config``).

Counterpart of `repro.configs.registry` without the dry-run's abstract
input specs. ``ARCHS`` lists every arch of the reference; ``PORT_ARCHS``
the archs the port runs that the reference lacks. Both resolve; an
unknown arch raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES as SHAPES  # re-exported via repro_torch.configs

_ARCH_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama3-405b": "llama3_405b",
    "stablelm-1.6b": "stablelm_1_6b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-0.6b": "qwen3_0_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
}

ARCHS = tuple(_ARCH_MODULES)

_PORT_ARCH_MODULES = {
    "granite-4.0-h-micro": "granite_4_0_h_micro",
}

PORT_ARCHS = tuple(_PORT_ARCH_MODULES)


def _module(arch: str):
    name = _ARCH_MODULES.get(arch) or _PORT_ARCH_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS + PORT_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
