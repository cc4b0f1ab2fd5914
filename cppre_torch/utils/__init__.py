"""Checkpointing and the carry-over of weights from the JAX package."""

from .checkpoint import (checkpoint_name, load_checkpoint, load_norms, save_checkpoint,
                         save_norms)
from .jax_params import fno2d_from_jax, normalizer_from_jax

__all__ = ["checkpoint_name", "load_checkpoint", "load_norms", "save_checkpoint",
           "save_norms", "fno2d_from_jax", "normalizer_from_jax"]
