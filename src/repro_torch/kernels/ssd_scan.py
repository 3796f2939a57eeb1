"""Python binding of the chunked SSD scan CUDA kernel (K4).

Counterpart of the TPU kernel `repro.kernels.ssd_scan`
(``ssd_scan_kernel``); the CUDA source, its bound and its design are in
``csrc/ssd_scan.cu``. From a zero state it computes the Mamba-2 scan
h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T, y_t = h_t C_t in the
chunked form and returns y (B, S, H, P) and the final state h_fin
(B, H, P, N), both float32. A ragged S (not a multiple of ``chunk``) is
masked in the kernel, with the reference's dt = 0 padding semantics.

Two bodies, each with its own wrapper, never one for the other after a
failure:

- ``ssd_scan_kernel`` (``ssd_scan_launch``): three passes of float32
  FMAs, every dtype and shape above.
- ``ssd_scan_tc_kernel`` (``ssd_scan_tc_launch``): a scores pass and a
  sequential pass per head on wgmma, for bfloat16 at P = 64, N = 128 and
  chunk 64, 128 or 256 (mamba2-1.3b's heads), with x, Bm and Cm on
  16-byte boundaries; it raises elsewhere. Its training gradients are as
  close to an f64 training step as the plain bf16 path's (the witness of
  ROADMAP.md Queue 3 item 1).

``ssd_body`` says which of the two the model's kernel path
(`repro_torch.kernels.ops.ssd_scan`) runs: the tensor-core body wherever
it takes the inputs, the CUDA-core body elsewhere.

The gradient of the tensor-core body's function is a kernel too:
``ssd_scan_bwd_tc_kernel`` (``ssd_scan_bwd_tc_launch``), on the same
domain, returns dx, ddt, dA, dBm and dCm from the saved inputs and the
output gradients, every product on wgmma with float32 accumulation (its
design is in the source's note). The JAX package has no backward kernel
for its scan (it differentiates its jnp path), so the kernel is held to
the plain twin ``ref.ssd_scan_bwd_ref`` and to autograd of the port's
``ref.ssd_chunked``. Elsewhere (float32, other shapes, the CPU) the
gradient is autograd of ``ref.ssd_chunked`` (`ops._SSDScan`).

The wrappers only launch: contiguous CUDA tensors, x/Bm/Cm in one of
float32 or bfloat16, dt and A in float32, P <= 64, N <= 128 and
1 <= chunk <= 1024, or they raise. `repro_torch.kernels.ops.ssd_scan` is
the entry point (CPU tensors to the plain version, and the gradient).
``_build.LAUNCHES`` counts calls, one key per body and one for the
backward: one call is its passes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import DTYPE_CODE, I, I64, P, Library

__all__ = [
    "MAX_P", "MAX_N", "MAX_CHUNK", "KERNEL_NAMES", "TC_CHUNKS",
    "ssd_body", "ssd_scan_kernel", "ssd_scan_tc_kernel", "ssd_scan_bwd_tc_kernel",
]

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024  # the tiles of the source
# The CUDA kernels each body launches, as a profiler names them.
KERNEL_NAMES = {
    "tensor_cores": ("ssd_scores_kernel", "ssd_scan_tc_kernel"),
    "cuda_cores": ("chunk_state_kernel", "state_pass_kernel", "chunk_output_kernel"),
    "backward": (
        "ssd_scores_kernel", "ssd_bwd_tables_kernel", "ssd_bwd_states_kernel",
        "ssd_bwd_dstates_kernel",
        "ssd_bwd_dx_kernel", "ssd_bwd_ds_kernel", "ssd_bwd_dbc_kernel", "ssd_bwd_da_kernel",
        "ssd_bwd_dA_kernel",
    ),
}
TC_CHUNKS = (64, 128, 256)

DTYPES = (torch.float32, torch.bfloat16)

_LIB = Library("ssd_scan", {
    "ssd_scan_launch": (I, [I, P, P, P, P, P, P, P, P, P, I, I64, I, I, I, I, P]),
    "ssd_scan_tc_launch": (I, [P, P, P, P, P, P, P, P, I, I64, I, I, P]),
    "ssd_scan_bwd_tc_workspace": (ctypes.c_size_t, [I, I64, I, I]),
    "ssd_scan_bwd_tc_launch": (I, [P] * 12 + [I, P, I, I64, I, I, P]),
})


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got x on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(
            f"x dtype {x.dtype} not supported; the kernel is built for "
            f"{sorted(str(d) for d in DTYPES)}"
        )
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got shape {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(
            f"P={P}, N={N}, chunk={chunk}: the kernel takes P <= {MAX_P}, "
            f"N <= {MAX_N}, 1 <= chunk <= {MAX_CHUNK}"
        )
    operands = (
        ("dt", dt, (B, S, H), torch.float32),
        ("A", A, (H,), torch.float32),
        ("Bm", Bm, (B, S, N), x.dtype),
        ("Cm", Cm, (B, S, N), x.dtype),
    )
    for name, t, shape, dtype in operands:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(
                f"{name}: want {shape} {dtype} on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _tc_refusal(x, Bm, Cm, chunk: int):
    """Why the tensor-core body cannot take these inputs (None when it
    can): beyond `_check`, it takes one shape, and x/Bm/Cm on 16-byte
    boundaries (it reads them with 16-byte loads)."""
    P, N = x.shape[-1], Bm.shape[-1]
    if not (x.dtype == torch.bfloat16 and (P, N) == (64, 128) and chunk in TC_CHUNKS):
        return (f"the tensor-core body takes bfloat16 with P = 64, N = 128 and chunk "
                f"in {TC_CHUNKS}, got {x.dtype}, P={P}, N={N}, chunk={chunk}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            return f"the tensor-core body needs {name} on a 16-byte boundary"
    return None


def ssd_body(x, Bm, Cm, chunk: int) -> str:
    """The body that `repro_torch.kernels.ops.ssd_scan` runs on these
    inputs: ``"tensor_cores"`` wherever that body takes them (bfloat16,
    P = 64, N = 128, chunk in ``TC_CHUNKS``, x/Bm/Cm on 16-byte
    boundaries), else ``"cuda_cores"``. A function of the inputs alone;
    a tensor-core launch that fails raises, it is not retried on the other
    body."""
    return "cuda_cores" if _tc_refusal(x, Bm, Cm, chunk) else "tensor_cores"


def ssd_scan_kernel(
    x: torch.Tensor,  # (B, S, H, P) float32 | bfloat16
    dt: torch.Tensor,  # (B, S, H) float32, post-softplus
    A: torch.Tensor,  # (H,) float32, negative
    Bm: torch.Tensor,  # (B, S, N), x's dtype
    Cm: torch.Tensor,  # (B, S, N), x's dtype
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) f32, h_fin (B, H, P, N) f32), zero initial
    state, from the CUDA-core body."""
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h_fin = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32, device=dev)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    _LIB.launch(
        "ssd_scan", dev,
        DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
        states.data_ptr(), decay.data_ptr(), B, S, H, P, N, chunk,
    )
    return y, h_fin


def ssd_scan_tc_kernel(
    x: torch.Tensor,  # (B, S, H, 64) bfloat16
    dt: torch.Tensor,  # (B, S, H) float32, post-softplus
    A: torch.Tensor,  # (H,) float32, negative
    Bm: torch.Tensor,  # (B, S, 128) bfloat16
    Cm: torch.Tensor,  # (B, S, 128) bfloat16
    chunk: int,  # one of TC_CHUNKS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ssd_scan_kernel`'s function from the tensor-core body."""
    refusal = _tc_refusal(x, Bm, Cm, chunk)
    if refusal:
        raise ValueError(refusal)
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h_fin = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    scores = torch.empty((B, nc, chunk, chunk), dtype=torch.float32, device=dev)
    _LIB.launch(
        "ssd_scan_tc", dev,
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), h_fin.data_ptr(), scores.data_ptr(), B, S, H, chunk,
    )
    return y, h_fin


def ssd_scan_bwd_tc_kernel(
    x: torch.Tensor,  # (B, S, H, 64) bfloat16
    dt: torch.Tensor,  # (B, S, H) float32
    A: torch.Tensor,  # (H,) float32
    Bm: torch.Tensor,  # (B, S, 128) bfloat16
    Cm: torch.Tensor,  # (B, S, 128) bfloat16
    gy: Optional[torch.Tensor],  # (B, S, H, 64) gradient of y, or None (zeros)
    gh: Optional[torch.Tensor],  # (B, H, 64, 128) gradient of h_fin, or None
    chunk: int,  # one of TC_CHUNKS
    grad_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of `ssd_scan_tc_kernel`'s function at these inputs:
    (dx, ddt, dA, dBm, dCm), dx, dBm and dCm in ``grad_dtype`` (bfloat16,
    the inputs' type, for autograd; float32 to read the kernel's sums before
    that rounding), ddt and dA in float32. The output gradients are taken
    in float32 (copied if they are another type, not contiguous or not on
    a 16-byte boundary). Raises where the tensor-core body would."""
    if grad_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"grad_dtype must be bfloat16 or float32, got {grad_dtype}")
    refusal = _tc_refusal(x, Bm, Cm, chunk)
    if refusal:
        raise ValueError(refusal)
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device

    def f32(t, shape, name):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: want {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
        t = t.to(torch.float32).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    gy = (torch.zeros((B, S, H, P), dtype=torch.float32, device=dev) if gy is None
          else f32(gy, (B, S, H, P), "gy"))
    gh = None if gh is None else f32(gh, (B, H, P, N), "gh")
    dx = torch.empty_like(x, dtype=grad_dtype)
    dBm, dCm = torch.empty_like(Bm, dtype=grad_dtype), torch.empty_like(Cm, dtype=grad_dtype)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    work = torch.empty((_LIB.fn("ssd_scan_bwd_tc_workspace")(B, S, H, chunk),),
                       dtype=torch.uint8, device=dev)
    _LIB.launch(
        "ssd_scan_bwd_tc", dev,
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        gy.data_ptr(), None if gh is None else gh.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
        int(grad_dtype == torch.float32), work.data_ptr(), B, S, H, chunk,
    )
    return dx, ddt, dA, dBm, dCm
