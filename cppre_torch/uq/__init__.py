"""Bayesian-UQ baseline harness: MC validators and the comparison protocol
(port of `cppre.uq`).

The model variants live in `cppre_torch.models.variants` and `swag`; this
package holds the per-method validation rollouts (`validation`), the
in/out-of-distribution data loaders (`data_loaders`), the variants' training
(`train`), the bootstrap comparison harness (`eval`) and its YAML-driven
entry point (`run_eval`, configs under `uq/configs/`). None of it has a kernel
of its own: the rollouts of dropout-free models run K4/K5, their training
K4-K7 and the PRE scores K8 (wave) or K2 (NS momentum, MHD energy) on the
card.
"""

from .eval import evaluate_uq_methods
from .validation import (
    validation_aer,
    validation_bayesian,
    validation_dropout,
    validation_ensemble,
    validation_mle,
    validation_pre,
    validation_swag,
)

__all__ = [
    "validation_dropout",
    "validation_ensemble",
    "validation_bayesian",
    "validation_swag",
    "validation_mle",
    "validation_aer",
    "validation_pre",
    "evaluate_uq_methods",
]
