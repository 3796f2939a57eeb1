"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` at first use. The
hash covers everything the compile reads from the repository: the source,
every local header it includes (``#include "x.cuh"`` under ``csrc/``,
followed recursively), the global ``NVCC_FLAGS`` and the source's own
``EXTRA_FLAGS``. An edited source or header rebuilds; an unchanged one is
reused. ``nvcc`` comes from ``$CUDA_HOME/bin``, the ``PATH``, or the
toolkit's default prefix, in that order. Nothing here imports or runs at
module import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

__all__ = ["NVCC_FLAGS", "EXTRA_FLAGS", "BUILD_DIR", "build", "build_key", "flags", "load"]

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
