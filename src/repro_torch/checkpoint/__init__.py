"""Host checkpointing of nested dicts of tensors as flat .npz archives, in
the reference's format (port of `repro.checkpoint`)."""

from .npz import latest_step, load_pytree, restore_step, save_pytree, save_step

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_step",
    "restore_step",
    "latest_step",
]
