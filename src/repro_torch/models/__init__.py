"""Model zoo of the port: the dense and hybrid families' serving paths and
the ssm family (mamba2), which also trains (``nn.Module``s over PyTorch,
kernels through `repro_torch.kernels`)."""

from .config import ModelConfig
from .params import from_reference, to_reference
from .registry import get_model

__all__ = ["ModelConfig", "get_model", "from_reference", "to_reference"]
