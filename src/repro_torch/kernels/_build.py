"""Build the package's CUDA sources with nvcc, load them with ctypes, and
launch their kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` at first use. The
hash covers everything the compile reads from the repository: the source,
every local header it includes (``#include "x.cuh"`` under ``csrc/``,
followed recursively), the global ``NVCC_FLAGS`` and the source's own
``EXTRA_FLAGS``. An edited source or header rebuilds; an unchanged one is
reused. ``nvcc`` comes from ``$CUDA_HOME/bin``, the ``PATH``, or the
toolkit's default prefix, in that order. Nothing is built or loaded at
module import time.

Every source's C interface follows one convention, which ``Library``
implements once: each kernel entry ``<kernel>`` is an export
``<kernel>_launch`` that returns an int error code (0 for success), takes
the current CUDA stream as its last argument and, where it takes several
types, a code from ``DTYPE_CODE``; an ``<name>_error_string`` export turns
a code into text. ``LAUNCHES`` counts the successful launches of every
kernel entry, so a run can show that its main path went through the
kernels; ``refuse_grad`` is the guard of the launchers that record no
gradient.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "NVCC_FLAGS", "EXTRA_FLAGS", "BUILD_DIR", "DTYPE_CODE", "LAUNCHES", "Library", "build",
    "build_key", "flags", "load", "refuse_grad",
]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register/spill report, kept in the .log beside the .so
)
# Flags of one source only, appended after NVCC_FLAGS (none yet: the
# tensor maps of flash_attention.cu reach the driver through the runtime,
# so nothing links libcuda).
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {}

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from source at first use"
    )


def local_headers(src: pathlib.Path) -> List[pathlib.Path]:
    """The headers ``src`` includes with quotes, resolved beside the file
    that includes them, recursively, in first-seen order. A quoted include
    that is not a file there (a toolkit header) is left to nvcc."""
    seen: List[pathlib.Path] = []
    todo = [src]
    while todo:
        cur = todo.pop()
        for inc in _LOCAL_INCLUDE.findall(cur.read_text()):
            path = (cur.parent / inc).resolve()
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def build_key(src: pathlib.Path, flags: Sequence[str]) -> str:
    """Hash of what compiling ``src`` with ``flags`` reads: the source, its
    local headers (by name and content) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update(b"\0" + "\0".join(flags).encode())
    return h.hexdigest()[:16]


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``: the global ones, then its own."""
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source, its
    headers and flags exists; returns the shared library's path."""
    src = CSRC / f"{name}.cu"
    nvcc_flags = flags(name)
    lib = BUILD_DIR / f"lib{name}_{build_key(src, nvcc_flags)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *nvcc_flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """Open the library of ``csrc/<name>.cu``, building it if needed. Each
    call opens it anew: callers keep the handle they get."""
    return ctypes.CDLL(str(build(name)))


# The type codes every source reads.
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# Successful launches of each kernel entry: one call of a binding, all its passes.
LAUNCHES: Dict[str, int] = dict.fromkeys((
    "coded_combine", "coded_admm_update", "flash_attention", "flash_attention_bwd",
    "rglru_scan", "rglru_scan_bwd", "ssd_scan", "ssd_scan_tc", "ssd_scan_bwd_tc",
    "causal_conv_silu", "causal_conv_silu_bwd",
), 0)
# The ctypes types of the exports' arguments: pointer, int, int64.
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


class Library:
    """The C interface of ``csrc/<name>.cu``: ``exports`` maps each function
    it calls to its ctypes signature ``(restype, argtypes)``, the stream
    included; ``errors`` names the error-text export (``<name>_error_string``
    unless given). The library is built and opened, and every export
    resolved, at the first use, never at import."""

    def __init__(self, name: str, exports: Dict[str, Tuple[type, list]],
                 errors: Optional[str] = None) -> None:
        self.name = name
        self.errors = errors or f"{name}_error_string"
        self.exports = {**exports, self.errors: (ctypes.c_char_p, [I])}
        self.fns: Dict[str, Callable] = {}  # filled at the first use

    def fn(self, export: str) -> Callable:
        """The ctypes function of ``export``."""
        if not self.fns:
            lib = load(self.name)
            fns = {}
            for name, (restype, argtypes) in self.exports.items():
                fns[name] = f = getattr(lib, name)
                f.restype, f.argtypes = restype, argtypes
            self.fns = fns
        return self.fns[export]

    def launch(self, kernel: str, device: torch.device, *args) -> None:
        """Call the export ``<kernel>_launch`` with ``args`` and ``device``'s
        current stream last, with ``device`` current. A nonzero return
        raises ``RuntimeError`` with the library's text for it; a launch
        that returns 0 counts in ``LAUNCHES[kernel]``."""
        f = self.fn(kernel + "_launch")
        with torch.cuda.device(device):
            err = f(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = self.fn(self.errors)(err).decode()
            raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
        LAUNCHES[kernel] += 1


def refuse_grad(launcher: str, entry: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where grad mode is on and one of ``tensors`` (None skipped)
    requires a gradient: the raw launcher would return outputs that drop
    it. ``entry`` names the function of `repro_torch.kernels.ops` to call
    instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{launcher} is a raw launcher and records no gradient: call "
            f"repro_torch.kernels.ops.{entry} (its autograd Function runs the backward "
            "kernel), or call this under torch.no_grad()"
        )
