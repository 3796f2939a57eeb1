"""Python binding of the flash-attention CUDA kernel (K3).

Counterpart of the TPU kernel `repro.kernels.flash_attention`
(``flash_attention_kernel``); the CUDA source, its bound and its design
are in ``csrc/flash_attention.cu``. The kernel reads the model's layout
directly: q (B, Sq, H, hd), k/v (B, Skv, KV, hd), out (B, Sq, H, hd).

The wrappers only launch: they take contiguous CUDA tensors of one dtype
(float32 or bfloat16) with hd in {64, 128, 256} and raise on anything
else. ``flash_attention_kernel`` is the forward (with ``return_lse`` it
also returns the rows' log-sum-exp, which the backward needs);
``flash_attention_bwd_kernel`` the backward (a prep, a main and a finish
kernel; ``bwd_plan`` says which main body runs, with how many keys a
block and which head split). Neither records a gradient:
`repro_torch.kernels.ops` is the entry point, whose autograd Function
pairs them on the card and which sends CPU tensors to the plain version.
``LAUNCHES`` counts calls of each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from . import _build

__all__ = [
    "LAUNCHES", "HEAD_DIMS", "BwdPlan", "bwd_plan", "flash_attention_kernel",
    "flash_attention_bwd_kernel",
]

HEAD_DIMS = (64, 128, 256)  # the instances compiled in the source
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
# The backward's main bodies by input dtype (the source's names), and the
# keys a block of each holds by head dim (kBK of bwd::tcb and bwd::Cfg).
BWD_BODIES = {torch.bfloat16: "flash_attention_bwd_tc_kernel",
              torch.float32: "flash_attention_bwd_kernel"}
BWD_KEYS = {
    "flash_attention_bwd_tc_kernel": {64: 64, 128: 64, 256: 64},
    "flash_attention_bwd_kernel": {64: 64, 128: 64, 256: 32},
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _I64, _I, _I64, _I64, _P,
    ]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_bwd_launch.argtypes = [
        _I, _I, *[_P] * 13, _I, _I, _I, _I64, _I64, _I, _I64, _I, _P,
    ]
    lib.flash_attention_bwd_launch.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q dtype {q.dtype} not supported; the kernel is built for "
            f"{sorted(str(d) for d in _DTYPE_CODE)}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B, S, heads, hd)")
    B, _, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; built for {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    for name, t, shape in (("k", k, (B, Skv, KV, hd)), ("v", v, (B, Skv, KV, hd))):
        if tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name}: want {shape} {q.dtype} on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a raw launcher and records no gradient: call "
            "repro_torch.kernels.ops.flash_attention (its autograd Function "
            "runs the backward kernel), or call this under torch.no_grad()"
        )


def _raise(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def flash_attention_kernel(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Attention of q over k/v with query positions ``arange(Sq) + q_offset``
    and key positions ``arange(Skv)``; out (B, Sq, H, hd) in q's dtype, and
    with ``return_lse`` also lse (B, H, Sq) float32, each row's log-sum-exp
    of its scaled scores.

    Under grad mode, inputs that require a gradient raise: this launcher
    would return an output that drops it."""
    _refuse_grad("flash_attention_kernel", q, k, v)
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_launch(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, H, KV, Sq,
            Skv, int(causal), 0 if window is None else int(window), int(q_offset),
            stream,
        )
    _raise(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def head_split(B: int, KV: int, q_per_kv: int, n_key_tiles: int, sms: int) -> int:
    """How many parts the backward splits each kv head's query heads into:
    the least power of two (dividing ``q_per_kv``) that gives the grid of
    (key tile, kv head, batch, part) blocks two blocks per SM, or all
    ``q_per_kv`` parts. MQA at batch 1 would otherwise leave most SMs
    idle; each part costs a float32 partial of dK and dV."""
    split = 1
    while split * n_key_tiles * B * KV < 2 * sms and q_per_kv % (2 * split) == 0:
        split *= 2
    return split


class BwdPlan(NamedTuple):
    body: str  # the main kernel's name: by dtype alone
    keys: int  # keys a block
    split: int  # parts of each kv head's query heads
    blocks: int  # the main kernel's grid


def bwd_plan(dtype: torch.dtype, B: int, KV: int, q_per_kv: int, Skv: int, hd: int,
             sms: int) -> BwdPlan:
    """The backward's launch plan: bf16 runs the tensor-core body and f32
    the CUDA-core body (no fallback between them), each with its own keys
    a block, and the head split that fills ``sms`` SMs."""
    body = BWD_BODIES[dtype]
    keys = BWD_KEYS[body][hd]
    n_key_tiles = -(-Skv // keys)
    split = head_split(B, KV, q_per_kv, n_key_tiles, sms)
    return BwdPlan(body, keys, split, n_key_tiles * split * B * KV)


def flash_attention_bwd_kernel(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, Sq, H, hd) the forward's output
    dout: torch.Tensor,  # its gradient
    lse: torch.Tensor,  # (B, H, Sq) float32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
):
    """(dq, dk, dv) of the attention with query positions from 0, in the
    inputs' dtype and layout. Scratch (float32) is allocated here."""
    _refuse_grad("flash_attention_bwd_kernel", q, k, v, out, dout)
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (
        ("out", out, q.shape, q.dtype), ("dout", dout, q.shape, q.dtype),
        ("lse", lse, (B, H, Sq), torch.float32),
    ):
        if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want a contiguous {tuple(shape)} {dtype} tensor on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.dtype == torch.bfloat16:  # the tensor-core body reads these by TMA
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"the tensor-core body needs {name} on a 16-byte boundary")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split = bwd_plan(q.dtype, B, KV, H // KV, Skv, hd, sms).split
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, Sq), **f32)
    dq_acc = torch.empty((B, Sq, H, hd), **f32)
    dk_part = torch.empty((split, B, Skv, KV, hd), **f32)
    dv_part = torch.empty_like(dk_part)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_bwd_launch(
            _DTYPE_CODE[q.dtype], hd, *(t.data_ptr() for t in (
                q, k, v, out, dout, lse, dq, dk, dv, delta, dq_acc, dk_part, dv_part)),
            B, H, KV, Sq, Skv, int(causal), 0 if window is None else int(window),
            split, stream,
        )
    _raise(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
