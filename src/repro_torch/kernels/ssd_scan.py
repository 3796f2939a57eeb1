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

The wrappers only launch: contiguous CUDA tensors, x/Bm/Cm in one of
float32 or bfloat16, dt and A in float32, P <= 64, N <= 128 and
1 <= chunk <= 1024, or they raise. `repro_torch.kernels.ops.ssd_scan` is
the entry point (CPU tensors to the plain version, and the gradient).
``LAUNCHES`` counts calls, one key per body: one call is its passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import _build

__all__ = [
    "LAUNCHES", "MAX_P", "MAX_N", "MAX_CHUNK", "KERNEL_NAMES", "TC_CHUNKS",
    "ssd_body", "ssd_scan_kernel", "ssd_scan_tc_kernel",
]

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024  # the tiles of the source
LAUNCHES: Dict[str, int] = {"ssd_scan": 0, "ssd_scan_tc": 0}
# The CUDA kernels each body launches, as a profiler names them.
KERNEL_NAMES = {
    "tensor_cores": ("ssd_scores_kernel", "ssd_scan_tc_kernel"),
    "cuda_cores": ("chunk_state_kernel", "state_pass_kernel", "chunk_output_kernel"),
}
TC_CHUNKS = (64, 128, 256)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _P,
    ]
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_tc_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, _P,
    ]
    lib.ssd_scan_tc_launch.restype = _I
    lib.ssd_scan_error_string.argtypes = [_I]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"x dtype {x.dtype} not supported; the kernel is built for "
            f"{sorted(str(d) for d in _DTYPE_CODE)}"
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
            states.data_ptr(), decay.data_ptr(), B, S, H, P, N, chunk, stream,
        )
    _raise_on(err)
    LAUNCHES["ssd_scan"] += 1
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_tc_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), h_fin.data_ptr(), scores.data_ptr(), B, S, H, chunk, stream,
        )
    _raise_on(err)
    LAUNCHES["ssd_scan_tc"] += 1
    return y, h_fin


def _raise_on(err: int) -> None:
    if err != 0:
        msg = _lib().ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} ({msg})")
