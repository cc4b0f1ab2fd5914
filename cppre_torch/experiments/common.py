"""Shared experiment utilities: LHS sampling and field stacking (port of
`cppre.experiments.common`).

`latin_hypercube` and `sample_params` are numpy and give the JAX package's
designs bit for bit from the same seed; the stacking helpers work on torch
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["latin_hypercube", "sample_params", "stacked_fields", "unstack_fields"]


def latin_hypercube(n_dims: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """Latin hypercube design in [0, 1]^d (pyDOE `lhs(d, n)` replacement):
    one sample per row, each dimension stratified into n_samples bins."""
    rng = np.random.RandomState(seed)
    out = np.empty((n_samples, n_dims), dtype=np.float64)
    for d in range(n_dims):
        perm = rng.permutation(n_samples)
        out[:, d] = (perm + rng.rand(n_samples)) / n_samples
    return out


def sample_params(lb, ub, n_samples: int, seed: int = 0) -> np.ndarray:
    """lb + (ub - lb) * lhs(d, n) — the universal reference pattern."""
    lb, ub = np.asarray(lb, dtype=np.float64), np.asarray(ub, dtype=np.float64)
    return (lb + (ub - lb) * latin_hypercube(len(lb), n_samples, seed)).astype(np.float32)


def stacked_fields(variables):
    """List of [BS, Nt, Nx, Ny] tensors -> [BS, Nvar, Nx, Ny, Nt] FNO layout."""
    return torch.stack([torch.movedim(torch.as_tensor(v, dtype=torch.float32), 1, -1)
                        for v in variables], dim=1)


def unstack_fields(field, axis: int = 1, variable_names=None):
    """[BS, Nvar, Nx, Ny, Nt] -> list of [BS, Nt, Nx, Ny]."""
    n = field.shape[axis]
    if variable_names is not None and len(variable_names) != n:
        raise ValueError("Number of tensors and variable names should match.")
    return [torch.movedim(p.squeeze(axis), -1, 1) for p in torch.split(field, 1, dim=axis)]
