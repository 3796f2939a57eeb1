"""PyTorch/CUDA port of `repro` (csI-ADMM, arXiv 2010.00914) for NVIDIA
Hopper.

Layout mirrors `repro` module for module; each ported module's reference
is its `repro` twin. Host-side code (`core`) is numpy and bit-for-bit the
reference's; device-side code is PyTorch on an explicit ``device`` (default
``"cuda"``, never a silent CPU fallback) and ``dtype`` (default
``torch.float32``; the parity tests run ``torch.float64``). The hot step's
fused decode-combine + x-update is a hand-written CUDA kernel
(`repro_torch.kernels`). This package imports neither `jax` nor `repro`.
"""
