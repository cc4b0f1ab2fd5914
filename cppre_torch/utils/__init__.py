"""Checkpointing, the carry-over of weights from the JAX package (FNOs,
the GS surrogates, the neural-ODE field), data
validation at load, and the YAML config reader."""

from .checkpoint import (checkpoint_name, load_checkpoint, load_norms, save_checkpoint,
                         save_norms)
from .config import KNOWN_KEYS, load_config, validate_config
from .jax_params import (cae_from_jax, fno1d_from_jax, fno2d_bayes_from_jax, fno2d_from_jax,
                         inr_from_jax, normalizer_from_jax, odefunc_from_jax)
from .validate import check_finite, check_shape, scrub_nan_sims

__all__ = ["checkpoint_name", "load_checkpoint", "load_norms", "save_checkpoint",
           "save_norms", "fno1d_from_jax", "fno2d_from_jax", "normalizer_from_jax", "check_finite",
           "check_shape", "scrub_nan_sims", "cae_from_jax", "inr_from_jax",
           "fno2d_bayes_from_jax", "odefunc_from_jax", "KNOWN_KEYS", "load_config",
           "validate_config"]
