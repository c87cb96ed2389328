"""Checkpoints and posterior-sample stores, in ``repro``'s layout."""
from .ckpt import (CheckpointManager, latest_step, list_steps,
                   load_pytree, save_pytree)

__all__ = ["CheckpointManager", "latest_step", "list_steps",
           "load_pytree", "save_pytree"]
