"""Inductive (split) conformal prediction primitives, in torch.

Port of `cppre.cp.inductive`; the same seven functions plus
`cp_quantile_level`:

* ``calibrate``        — split-CP quantile over the batch axis, 'higher'
                         interpolation at level ceil((n+1)(1-alpha))/n;
* ``emp_cov`` / ``emp_cov_joint`` — marginal / joint empirical coverage;
* ``modulation_func``  — per-cell *population* std of (a - b) over the
                         calibration axis (``correction=0``, like ``jnp.std``);
* ``ncf_metric_joint`` — per-sample sup-norm of |a - b| / modulation;
* the two filtering helpers.

Inputs may be torch tensors or anything ``torch.as_tensor`` takes.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span

__all__ = [
    "calibrate",
    "cp_quantile_level",
    "emp_cov",
    "emp_cov_joint",
    "modulation_func",
    "ncf_metric_joint",
    "filter_sims_within_bounds",
    "filter_sims_joint",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _rest(x):
    return tuple(range(1, x.ndim))


def cp_quantile_level(n: int, alpha: float) -> float:
    """The finite-sample-corrected split-CP level ceil((n+1)(1-alpha))/n, capped at 1."""
    return min(math.ceil((n + 1) * (1 - alpha)) / n, 1.0)


def quantile_index(level: float, n: int, dtype=torch.float32) -> int:
    """Sorted-order index that the 'higher' quantile at `level` selects among
    `n` scores: ceil(level * (n - 1)), evaluated in the scores' dtype as
    `jnp.quantile` evaluates it."""
    pos = torch.tensor(level, dtype=dtype) * torch.tensor(n - 1, dtype=dtype)
    return int(torch.ceil(pos))


def calibrate(scores, n: int | None = None, alpha: float = 0.1):
    """qhat = Quantile(scores; ceil((n+1)(1-alpha))/n) over the batch axis.

    `scores` is [n, *field] (marginal CP: qhat has field shape) or [n]
    (joint CP: a 0-d qhat). The 'higher' interpolation returns an actual
    calibration score. Implemented with `kthvalue` (not `torch.quantile`,
    which refuses inputs above 2**24 elements).
    """
    scores = _t(scores)
    if n is None:
        n = scores.shape[0]
    idx = quantile_index(cp_quantile_level(n, alpha), scores.shape[0], scores.dtype)
    return torch.kthvalue(scores, idx + 1, dim=0).values


def emp_cov(prediction_sets, y_response) -> float:
    """Marginal empirical coverage: mean fraction of cells inside the sets."""
    lower, upper = prediction_sets
    y = _t(y_response)
    return float(((y >= lower) & (y <= upper)).float().mean())


def filter_sims_joint(prediction_sets, y_response):
    """Boolean mask of samples entirely inside the joint sets (the span
    `cp.accept`)."""
    lower, upper = prediction_sets
    y = _t(y_response)
    with span("cp.accept", y):
        inside = (y >= lower) & (y <= upper)
        return inside.reshape(y.shape[0], -1).all(dim=1)


def emp_cov_joint(prediction_sets, y_response) -> float:
    """Joint empirical coverage: fraction of samples *entirely* inside."""
    return float(filter_sims_joint(prediction_sets, y_response).float().mean())


def modulation_func(a, b=None):
    """Per-cell spread of (a - b) over the calibration axis: the population
    std, std(a - b, axis=0, correction=0). Callers add their own guard."""
    a = _t(a)
    diff = a if b is None else a - _t(b)
    return torch.std(diff, dim=0, correction=0)


def ncf_metric_joint(a, b, modulation):
    """Per-sample sup-norm nonconformity: max over non-batch axes of |a-b|/mod."""
    a = _t(a)
    diff = a if b is None else a - _t(b)
    return torch.amax(diff.abs() / modulation, dim=_rest(diff))


def filter_sims_within_bounds(lower_bound, upper_bound, samples, threshold, within=False):
    """Boolean mask of samples whose fraction of cells in (within=True) or
    out (within=False) of the bounds is >= threshold (the span `cp.accept`)."""
    samples = _t(samples)
    lower, upper = _t(lower_bound), _t(upper_bound)
    with span("cp.accept", samples):
        if within:
            mask = (samples >= lower) & (samples <= upper)
        else:
            mask = (samples <= lower) | (samples >= upper)
        return mask.float().mean(dim=_rest(samples)) >= threshold
