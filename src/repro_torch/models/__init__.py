"""Model zoo of the port: every family of `repro` (dense, MoE, VLM, ssm,
hybrid, audio), serving and training (``nn.Module``s over PyTorch,
kernels through `repro_torch.kernels`)."""

from .config import ModelConfig
from .params import from_reference, to_reference
from .registry import get_model

__all__ = ["ModelConfig", "get_model", "from_reference", "to_reference"]
