"""Carry the reference's weights into the port.

``from_reference(cfg, tree, device)`` takes `repro`'s parameter pytree
(``model.init(key)``) as numpy arrays and returns the port's model holding
those weights. Both keep weights ``(in, out)``, so loading is a slice of
the reference's stacked arrays per layer and nothing is transposed:

  dense:  layers[name][l]                    -> layers[l].<name>
  hybrid: rec[name][g, r], attn[name][g],    -> rec[g][r], attn[g],
          tail_rec[name][t]                     tail_rec[t]

Every parameter of the port must be set and every array of the tree
used, or it raises.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from .config import ModelConfig
from .registry import empty_model

__all__ = ["from_reference"]


def _tensor(a) -> torch.Tensor:
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
    if cfg.family == "dense":
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
