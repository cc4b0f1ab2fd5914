"""Training and rollout: losses, normalizers, the AR rollout and the training
loops (port of `cppre.train`)."""

from .losses import LpLoss, lp_loss, mae, mse
from .loops import (TrainState, fit, make_optimizer, make_train_step, resolve_remat_policy,
                    train_one_epoch_AR)
from .normalizers import GaussianNormalizer, Identity, MinMaxNormalizer, RangeNormalizer
from .rollout import autoregressive_rollout, validation_AR

MinMax_Normalizer = MinMaxNormalizer  # reference-name alias

__all__ = [
    "LpLoss",
    "lp_loss",
    "mse",
    "mae",
    "MinMaxNormalizer",
    "MinMax_Normalizer",
    "RangeNormalizer",
    "GaussianNormalizer",
    "Identity",
    "autoregressive_rollout",
    "validation_AR",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "train_one_epoch_AR",
    "fit",
    "resolve_remat_policy",
]
