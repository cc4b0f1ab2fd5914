"""Checkpointing, the carry-over of weights from the JAX package, and data
validation at load."""

from .checkpoint import (checkpoint_name, load_checkpoint, load_norms, save_checkpoint,
                         save_norms)
from .jax_params import fno1d_from_jax, fno2d_from_jax, normalizer_from_jax
from .validate import check_finite, check_shape, scrub_nan_sims

__all__ = ["checkpoint_name", "load_checkpoint", "load_norms", "save_checkpoint",
           "save_norms", "fno1d_from_jax", "fno2d_from_jax", "normalizer_from_jax", "check_finite",
           "check_shape", "scrub_nan_sims"]
