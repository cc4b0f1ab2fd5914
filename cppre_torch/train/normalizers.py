"""Data normalizers, in torch (port of `cppre.train.normalizers`).

All normalizers are affine, ``encode(x) = a*x + b`` and
``decode(y) = (y - b) / a``, with float32 tensors ``a`` and ``b``; they
serialize to the reference's `{in_a, in_b, out_a, out_b}` npz contract
(`cppre_torch.utils.checkpoint.save_norms`). ``from_ab`` rebuilds one from
saved coefficients, including those of a `cppre` normalizer. Normalizers
fitted to data live on the data's device; `from_ab` and `Identity` make
their coefficients from nothing and put them on the card unless the caller
passes `device="cpu"` (`Identity(x)` follows a tensor `x`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MinMaxNormalizer", "RangeNormalizer", "GaussianNormalizer", "Identity"]


def _f32(v, device=None):
    if isinstance(v, np.ndarray) and not v.flags.writeable:
        v = v.copy()  # e.g. a JAX array's host view
    return torch.as_tensor(v, dtype=torch.float32, device=device)


class _AffineNormalizer:
    """encode(x) = a*x + b ; decode(y) = (y - b) / a."""

    def __init__(self, a, b, device=None):
        self.a = _f32(a, device)
        self.b = _f32(b, device)

    def encode(self, x):
        return self.a * x + self.b

    def decode(self, y):
        return (y - self.b) / self.a

    def to(self, device):
        """Move the coefficients to `device` (in place); returns self."""
        self.a, self.b = self.a.to(device), self.b.to(device)
        return self

    @classmethod
    def from_ab(cls, a, b, device="cuda"):
        obj = cls.__new__(cls)
        _AffineNormalizer.__init__(obj, a, b, device)
        return obj


class MinMaxNormalizer(_AffineNormalizer):
    """Map the global [min, max] of x onto [low, high] (scalar a, b)."""

    def __init__(self, x, low=0.0, high=1.0):
        x = _f32(x)
        mn, mx = torch.amin(x), torch.amax(x)
        a = (high - low) / (mx - mn)
        super().__init__(a, -a * mx + high, x.device)


class RangeNormalizer(_AffineNormalizer):
    """Per-cell [min, max] over the batch axis onto [low, high]."""

    def __init__(self, x, low=0.0, high=1.0):
        x = _f32(x)
        mn, mx = torch.amin(x, dim=0), torch.amax(x, dim=0)
        a = (high - low) / (mx - mn)
        super().__init__(a, -a * mx + high, x.device)


class GaussianNormalizer(_AffineNormalizer):
    """Standardize by global mean/std: encode = (x - mean) / (std + eps)."""

    def __init__(self, x, eps=1e-5):
        x = _f32(x)
        std = torch.std(x, correction=0) + eps
        super().__init__(1.0 / std, -torch.mean(x) / std, x.device)


class Identity(_AffineNormalizer):
    def __init__(self, x=None, device="cuda"):
        if isinstance(x, torch.Tensor):
            device = x.device
        super().__init__(1.0, 0.0, device)
