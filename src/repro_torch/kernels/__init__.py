"""Hand-written Hopper kernels for the compute hot-spots, with their plain
PyTorch versions.

  coded_combine / coded_admm_update (K1, K2) — fused gradient decode
      (+ eq. 5a x-update): the csI-ADMM agent-side hot spot (memory-bound
      reduce). ``csrc/coded_combine.cu``.
  flash_attention (K3) — causal / sliding-window / GQA online-softmax
      attention of every transformer and RecurrentGemma attention layer,
      with a backward kernel for training. ``csrc/flash_attention.cu``.
  rglru_scan (K5) — the RG-LRU linear recurrence of every RecurrentGemma
      recurrent layer, with a backward kernel (the reverse scan).
      ``csrc/rglru_scan.cu``.
  ssd_scan (K4) — the chunked Mamba-2 SSD scan of the mamba2 training
      forward, with a backward kernel. ``csrc/ssd_scan.cu``.
  causal_conv_silu — the Mamba-2 mixer's causal depthwise conv + SiLU
      before the scan, forward and backward (no TPU kernel behind it: the
      reference leaves it to XLA). ``csrc/causal_conv.cu``.

All are CUDA C++ for sm_90a. `ops` holds the public entry points (CUDA
tensors -> kernel, CPU tensors -> plain version); `ref` the plain PyTorch
versions (the forms the models' plain paths use too); `coded_combine`,
`flash_attention`, `rglru_scan`, `ssd_scan` and `causal_conv` the ctypes
bindings; `_build` the nvcc build and their one launch path (loader, error
text, launch counter ``LAUNCHES``, grad refusal). Nothing here imports
the model layer.
"""

from .ops import (
    causal_conv_silu,
    coded_admm_update,
    coded_combine,
    flash_attention,
    rglru_scan,
    ssd_scan,
)

__all__ = [
    "causal_conv_silu",
    "coded_combine",
    "coded_admm_update",
    "flash_attention",
    "rglru_scan",
    "ssd_scan",
]
