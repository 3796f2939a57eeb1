"""Flat-key .npz checkpointing (atomic writes, step directories) in the
reference's format (port of `repro.checkpoint.npz`).

A tree is a nested dict whose leaves are torch tensors or numpy arrays.
Keys join the dict path with '/' (``layers/w_in``); bfloat16 leaves are
stored as a uint16 view (npz has no bf16 dtype) and listed in a sidecar
``__bf16__`` array. `repro.checkpoint.restore_step` reads a file written
here and `load_pytree` here reads one written there. Loading returns CPU
torch tensors (bf16 restored from the view), so numpy needs no bf16 type.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "save_step", "restore_step", "latest_step"]

_SEP = "/"


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for key in sorted(tree):
        v = tree[key]
        path = f"{prefix}{key}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + _SEP))
        else:
            flat[path] = v
    return flat


def _to_numpy(v) -> Tuple[np.ndarray, bool]:
    """(array, is_bf16): bf16 comes back as its uint16 bit pattern."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(np.uint16), True
        return v.numpy(), False
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":  # an ml_dtypes array
        return v.view(np.uint16), True
    return v, False


def save_pytree(path: str, tree: Mapping) -> None:
    arrays, bf16 = {}, []
    for k, v in _flatten(tree).items():
        arrays[k], is_bf16 = _to_numpy(v)
        if is_bf16:
            bf16.append(k)
    arrays["__bf16__"] = np.array(bf16, dtype=np.str_)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # atomic: write to a temp file in the same dir, then rename
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, like: Optional[Mapping] = None) -> dict:
    """Load a nested dict of CPU tensors; with ``like``, its keys and
    shapes must match exactly (missing, extra or reshaped leaves raise)."""
    with np.load(path, allow_pickle=False) as z:
        bf16 = set(z["__bf16__"].tolist()) if "__bf16__" in z else set()
        flat = {k: z[k] for k in z.files if k != "__bf16__"}
    if like is not None:
        ref = _flatten(like)
        if set(flat) != set(ref):
            missing, extra = set(ref) - set(flat), set(flat) - set(ref)
            raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")
        for k, v in ref.items():
            if tuple(flat[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: shape {flat[k].shape} != expected {tuple(v.shape)}")
    out: dict = {}
    for key, arr in flat.items():
        t = torch.from_numpy(np.array(arr))
        if key in bf16:
            t = t.view(torch.int16).view(torch.bfloat16)
        node = out
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def save_step(ckpt_dir: str, step: int, tree: Mapping) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    save_pytree(path, tree)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)\.npz", f))
    ]
    return max(steps) if steps else None


def restore_step(
    ckpt_dir: str, like: Optional[Mapping] = None, step: Optional[int] = None
) -> Tuple[Any, int]:
    """Load a step checkpoint (the latest when ``step`` is None); returns
    ``(tree, step)``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return load_pytree(os.path.join(ckpt_dir, f"step_{step:08d}.npz"), like), step
