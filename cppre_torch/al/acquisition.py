"""Acquisition functions (port of `cppre.al.acquisition`).

`params` is the candidate pool as numpy rows (the LHS design, numpy in both
packages), `pred_residual` the candidates' residuals, a torch tensor on any
device or an array. Each function returns the chosen rows of `params` as
numpy, so that the solver takes them as it takes any design. The CP rules
run the port's `cp.inductive` functions on the residuals' device; the PRE
ranking runs in numpy, as in cppre, so that equal inputs rank equally.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cp.inductive import calibrate, filter_sims_joint, filter_sims_within_bounds

__all__ = ["acquire_cp", "acquire_cp_marginal", "acquire_pre", "acquire_rand"]


def _on(x, device=None):
    """x as a float32 tensor on `device` (a tensor's own device by default,
    the CPU for an array)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device or x.device, dtype=torch.float32)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def acquire_cp(params, pred_residual, cal_scores, modulation, alpha: float = 0.5):
    """Joint-CP rejection: the candidates whose residual leaves the band
    [-qhat * mod, +qhat * mod] somewhere (the mask of `filter_sims_joint`
    inverted). Returns the rejected parameter rows."""
    res = _on(pred_residual)
    qhat = calibrate(_on(cal_scores, res.device), len(cal_scores), alpha)
    mod = _on(modulation, res.device)
    inside = filter_sims_joint((-qhat * mod, qhat * mod), res)
    return np.asarray(params)[~_numpy(inside)]


def acquire_cp_marginal(params, pred_residual, cal_scores, alpha: float = 0.5,
                        threshold: float = 0.5):
    """Marginal-CP rejection: a per-cell qhat from the calibration scores
    [n, *field]; the candidates whose fraction of cells OUTSIDE
    [-qhat, +qhat] reaches `threshold` are acquired."""
    res = _on(pred_residual)
    qhat = calibrate(_on(cal_scores, res.device), len(cal_scores), alpha)
    mask = filter_sims_within_bounds(-qhat, qhat, res, threshold, within=False)
    return np.asarray(params)[_numpy(mask)]


def acquire_pre(params, pred_residual, alpha: float = 0.5, largest: bool = True):
    """Rank the candidates by mean |residual| and take the (1 - alpha)
    fraction: the largest residuals (the documented intent, the most
    informative), or with `largest=False` the smallest, as the reference's
    ascending sort under its comment "Descending order of PRE" does."""
    pred_residual = _numpy(pred_residual)
    mean_res = np.abs(pred_residual).mean(axis=tuple(range(1, pred_residual.ndim)))
    order = np.argsort(mean_res)
    if largest:
        order = order[::-1]
    num = int((1 - alpha) * len(params))
    return np.asarray(params)[order][:num]


def acquire_rand(params, alpha: float = 0.5, seed: int = 0):
    """Random acquisition, with replacement, by `np.random.RandomState(seed)`:
    the rows cppre draws."""
    rng = np.random.RandomState(seed)
    num = int((1 - alpha) * len(params))
    return np.asarray(params)[rng.randint(0, len(params), num)]
