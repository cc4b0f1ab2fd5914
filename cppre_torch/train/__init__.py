"""Rollout and normalizers (the inference half of `cppre.train`)."""

from .normalizers import GaussianNormalizer, Identity, MinMaxNormalizer, RangeNormalizer
from .rollout import autoregressive_rollout, validation_AR

MinMax_Normalizer = MinMaxNormalizer  # reference-name alias

__all__ = [
    "MinMaxNormalizer",
    "MinMax_Normalizer",
    "RangeNormalizer",
    "GaussianNormalizer",
    "Identity",
    "autoregressive_rollout",
    "validation_AR",
]
