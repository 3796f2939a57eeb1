"""Carry weights between the reference's layout and the port's.

``from_reference(cfg, tree, device)`` takes `repro`'s parameter pytree
(``model.init(key)``) as numpy arrays (or CPU tensors, as a checkpoint
loads them) and returns the port's model holding those weights. Both keep
weights ``(in, out)``, so loading is a slice of the reference's stacked
arrays per layer and nothing is transposed:

  dense, ssm: layers[name][l]                -> layers[l].<name>
  hybrid:     rec[name][g, r], attn[name][g],  -> rec[g][r], attn[g],
              tail_rec[name][t]                  tail_rec[t]

Every parameter of the port must be set and every array of the tree
used, or it raises. ``to_reference(model)`` is the inverse: the
reference's stacked tree, as CPU tensors (numpy has no bfloat16 type of
its own; `repro_torch.checkpoint` writes the tree in the reference's
format).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .config import ModelConfig
from .registry import empty_model

__all__ = ["from_reference", "to_reference"]


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native twin
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _load(module, arrays: Mapping, index, used: set, prefix: str) -> None:
    for name, p in module.named_parameters(recurse=False):
        if name not in arrays:
            raise KeyError(f"reference tree has no {prefix}{name}")
        src = _tensor(arrays[name])[index]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"{prefix}{name}: reference shape {tuple(src.shape)}, port "
                f"{tuple(p.shape)}"
            )
        p.copy_(src.to(p.dtype))
        used.add(prefix + name)


@torch.no_grad()
def from_reference(
    cfg: ModelConfig, tree: Mapping, device: Union[str, torch.device] = "cuda"
):
    """The port's model for ``cfg`` with the weights of ``tree``."""
    model = empty_model(cfg, device)
    used: set = set()
    _load(model, tree, (), used, "")
    if cfg.family in ("dense", "ssm"):
        for l, blk in enumerate(model.layers):
            _load(blk, tree["layers"], l, used, "layers/")
    else:
        for g, attn in enumerate(model.attn):
            for r, blk in enumerate(model.rec[g]):
                _load(blk, tree["rec"], (g, r), used, "rec/")
            _load(attn, tree["attn"], g, used, "attn/")
        for t, blk in enumerate(model.tail_rec):
            _load(blk, tree["tail_rec"], t, used, "tail_rec/")
    want = {
        f"{top}/{k}" if isinstance(v, Mapping) else top
        for top, v in tree.items()
        for k in (v if isinstance(v, Mapping) else [None])
    }
    if want - used:
        raise KeyError(f"reference arrays the port does not hold: {sorted(want - used)}")
    return model


def _stack(blocks) -> dict:
    """{name: tensor stacked over ``blocks``} (nested lists stack in order)."""
    names = [n for n, _ in blocks[0].named_parameters(recurse=False)]
    return {n: torch.stack([getattr(b, n).detach().cpu() for b in blocks]) for n in names}


@torch.no_grad()
def to_reference(model) -> Dict[str, Any]:
    """The reference's parameter tree of ``model`` as CPU tensors: the
    model's own parameters by name, the layers stacked as the reference
    stacks them (``from_reference`` reads it back)."""
    tree: Dict[str, Any] = {
        n: p.detach().cpu() for n, p in model.named_parameters(recurse=False)
    }
    if model.cfg.family in ("dense", "ssm"):
        tree["layers"] = _stack(list(model.layers))
        return tree
    G, R = len(model.attn), len(model.rec[0])
    rec = _stack([blk for g in range(G) for blk in model.rec[g]])
    tree["rec"] = {n: t.reshape(G, R, *t.shape[1:]) for n, t in rec.items()}
    tree["attn"] = _stack(list(model.attn))
    if len(model.tail_rec):
        tree["tail_rec"] = _stack(list(model.tail_rec))
    return tree
