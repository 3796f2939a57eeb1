"""Hand-written Hopper kernels for the compute hot-spots, with their plain
PyTorch versions.

  coded_combine / coded_admm_update — fused gradient decode (+ eq. 5a
      x-update): the csI-ADMM agent-side hot spot (memory-bound reduce).
      CUDA C++ for sm_90a in ``csrc/coded_combine.cu``.

`ops` holds the public entry points (CUDA tensors -> kernel, CPU tensors
-> plain version); `ref` the plain PyTorch versions; `coded_combine` the
ctypes bindings with their launch counters; `_build` the nvcc build. The
reference's model kernels (flash attention, SSD scan, RG-LRU scan) are not
ported yet (ROADMAP Queue 2, K3-K5).
"""

from .ops import coded_admm_update, coded_combine

__all__ = ["coded_combine", "coded_admm_update"]
