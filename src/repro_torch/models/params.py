"""Carry weights between the reference's layout and the port's.

``from_reference(cfg, tree, device)`` takes `repro`'s parameter pytree
(``model.init(key)``) as numpy arrays (or CPU tensors, as a checkpoint
loads them) and returns the port's model holding those weights. Both keep
weights ``(in, out)``, so loading is a slice of the reference's stacked
arrays per layer and nothing is transposed:

  dense, moe, vlm, ssm: layers[name][l]      -> layers[l].<name>
              (an MoE layer's (L, E, ...) experts: the (E, ...) slice)
  hybrid:     rec[name][g, r], attn[name][g],  -> rec[g][r], attn[g],
              tail_rec[name][t]                  tail_rec[t]
  audio:      enc[name][l], dec[name][l]       -> enc[l].<name>, dec[l].<name>
  granite:    mamba[name][i], attention[name][j] -> layers[l].<name>, the layers
              of each kind stacked apart in order (the port's own family: its
              checkpoints have this layout, no reference has one)

Every parameter of the port must be set and every array of the tree
used, or it raises. ``to_reference(model)`` is the inverse: the
reference's stacked tree, as CPU tensors (numpy has no bfloat16 type of
its own; `repro_torch.checkpoint` writes the tree in the reference's
format).

``reference_index(model)`` holds the mapping, parameter name -> (path,
index). It carries any flat ``{parameter name: tensor}`` dict, as the
consensus runtime keeps its state: ``flat_from_reference(model, tree,
lead)`` and ``flat_to_reference(model, flat, lead)`` with ``lead`` leading
axes (the agent axis of x and y) on every leaf, and
``consensus_state_from_reference`` / ``consensus_state_to_reference``
for the reference's whole csI-ADMM state (x and y with a leading agent
axis, z, k).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .config import ModelConfig
from .registry import empty_model

__all__ = [
    "from_reference",
    "to_reference",
    "reference_index",
    "flat_from_reference",
    "flat_to_reference",
    "consensus_state_from_reference",
    "consensus_state_to_reference",
]


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native twin
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


@torch.no_grad()
def from_reference(
    cfg: ModelConfig, tree: Mapping, device: Union[str, torch.device] = "cuda"
):
    """The port's model for ``cfg`` with the weights of ``tree``."""
    model = empty_model(cfg, device)
    flat = flat_from_reference(model, tree, 0, "cpu")
    for name, p in model.named_parameters():
        src = flat[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: reference shape {tuple(src.shape)}, port {tuple(p.shape)}"
            )
        p.copy_(src.to(p.dtype))
    used = {"/".join(path) for path, _ in reference_index(model).values()}
    want = {
        f"{top}/{k}" if isinstance(v, Mapping) else top
        for top, v in tree.items()
        for k in (v if isinstance(v, Mapping) else [None])
    }
    if want - used:
        raise KeyError(f"reference arrays the port does not hold: {sorted(want - used)}")
    return model


def to_reference(model) -> Dict[str, Any]:
    """The reference's parameter tree of ``model`` as CPU tensors: the
    model's own parameters by name, the layers stacked as the reference
    stacks them (``from_reference`` reads it back)."""
    return flat_to_reference(model, dict(model.named_parameters()))


def reference_index(model) -> Dict[str, tuple]:
    """{parameter name: (path in the reference's tree, index into the
    stacked array)} for every parameter of ``model``."""
    def own(module, path, index, prefix):
        return {
            prefix + name: ((*path, name), index)
            for name, _ in module.named_parameters(recurse=False)
        }

    out = own(model, (), (), "")
    if model.cfg.family == "granite":
        for l, blk in enumerate(model.layers):
            out.update(own(blk, (blk.kind,), (model.slots[l],), f"layers.{l}."))
        return out
    if model.cfg.family == "audio":
        for stack in ("enc", "dec"):
            for l, blk in enumerate(getattr(model, stack)):
                out.update(own(blk, (stack,), (l,), f"{stack}.{l}."))
        return out
    if model.cfg.family != "hybrid":
        for l, blk in enumerate(model.layers):
            out.update(own(blk, ("layers",), (l,), f"layers.{l}."))
        return out
    for g, attn in enumerate(model.attn):
        for r, blk in enumerate(model.rec[g]):
            out.update(own(blk, ("rec",), (g, r), f"rec.{g}.{r}."))
        out.update(own(attn, ("attn",), (g,), f"attn.{g}."))
    for t, blk in enumerate(model.tail_rec):
        out.update(own(blk, ("tail_rec",), (t,), f"tail_rec.{t}."))
    return out


def _at(tree: Mapping, path: tuple):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError(f"reference tree has no {'/'.join(path)}")
        node = node[key]
    return node


def flat_from_reference(
    model, tree: Mapping, lead: int = 0, device=None
) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} from the reference's tree whose leaves have
    ``lead`` leading axes before the stacked layer axes; tensors on
    ``device`` (the model's when None)."""
    device = model.device if device is None else device
    arrays: Dict[tuple, torch.Tensor] = {}
    out = {}
    for name, (path, index) in reference_index(model).items():
        if path not in arrays:
            arrays[path] = _tensor(_at(tree, path))
        out[name] = arrays[path][(slice(None),) * lead + index].contiguous().to(device)
    return out


@torch.no_grad()
def flat_to_reference(model, flat: Mapping[str, torch.Tensor], lead: int = 0) -> Dict[str, Any]:
    """The reference's stacked tree (CPU tensors) of a flat {parameter
    name: tensor} dict whose tensors have ``lead`` leading axes."""
    index = reference_index(model)
    groups: Dict[tuple, list] = {}
    for name, (path, idx) in index.items():
        groups.setdefault(path, []).append((idx, flat[name].detach().cpu()))
    tree: Dict[str, Any] = {}
    for path, items in groups.items():
        first = items[0][1]
        grid = tuple(max(i[d] for i, _ in items) + 1 for d in range(len(items[0][0])))
        lead_shape, shape = first.shape[:lead], first.shape[lead:]
        out = first.new_empty((*lead_shape, *grid, *shape))
        for idx, t in items:
            out[(slice(None),) * lead + idx] = t
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = out
    return tree


def consensus_state_from_reference(model, state: Mapping, device=None) -> dict:
    """The port's consensus state from the reference's ({"x", "y": trees
    with a leading agent axis, "z": tree, "k"}; numpy or tensor leaves)."""
    return {
        "x": flat_from_reference(model, state["x"], 1, device),
        "y": flat_from_reference(model, state["y"], 1, device),
        "z": flat_from_reference(model, state["z"], 0, device),
        "k": int(np.asarray(state["k"])),
    }


def consensus_state_to_reference(model, state: Mapping) -> dict:
    """The reference's consensus state (CPU tensor leaves, k an int) of the
    port's."""
    return {
        "x": flat_to_reference(model, state["x"], 1),
        "y": flat_to_reference(model, state["y"], 1),
        "z": flat_to_reference(model, state["z"], 0),
        "k": int(state["k"]),
    }
