"""The shared CP-experiment engine: calibrate -> sweep -> filter (port of
`cppre.experiments.pipeline`).

The alpha sweep sorts the calibration scores once and gathers every
alpha's quantile from the sorted tensor, instead of re-sorting per alpha.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cp.inductive import (
    _t,
    calibrate,
    cp_quantile_level,
    filter_sims_joint,
    filter_sims_within_bounds,
    modulation_func,
    ncf_metric_joint,
    quantile_index,
)

__all__ = [
    "marginal_coverage_sweep",
    "joint_coverage_sweep",
    "marginal_cp",
    "joint_cp",
    "DEFAULT_ALPHAS",
]

DEFAULT_ALPHAS = np.arange(0.05, 0.95 + 0.1, 0.1)


def _qhats_for_alphas(scores, alphas):
    """All split-CP quantiles in one pass: sort once, gather per alpha
    ('higher' interpolation, the index `calibrate` selects)."""
    n = scores.shape[0]
    idx = [quantile_index(cp_quantile_level(n, float(a)), n, scores.dtype)
           for a in np.asarray(alphas)]
    sorted_scores = torch.sort(scores, dim=0).values
    return sorted_scores[torch.as_tensor(idx, device=scores.device)]


def _center_target(pred_residual, target_residual, dtype, device):
    if target_residual is None:   # PRE-only: does pred_residual fall in ±width?
        return torch.zeros((), dtype=dtype, device=device), _t(pred_residual)
    return _t(pred_residual), _t(target_residual)


def marginal_coverage_sweep(cal_scores, pred_residual, target_residual=None,
                            alphas=DEFAULT_ALPHAS):
    """Per-cell CP sweep. cal_scores [n_cal, *field]; sets are
    pred_residual -/+ qhat (AER+PRE) or, with target_residual None,
    [-qhat, +qhat] around 0 tested on pred_residual (PRE-only).
    Returns (alphas, coverages [n_alpha]) as numpy arrays."""
    cal_scores = _t(cal_scores)
    qhats = _qhats_for_alphas(cal_scores, alphas)
    center, target = _center_target(pred_residual, target_residual, qhats.dtype,
                                    qhats.device)
    cov = [((target >= center - q) & (target <= center + q)).float().mean() for q in qhats]
    return np.asarray(alphas), torch.stack(cov).cpu().numpy()


def joint_coverage_sweep(cal_scores, modulation, pred_residual, target_residual=None,
                         alphas=DEFAULT_ALPHAS):
    """Sup-norm (joint) CP sweep. cal_scores [n_cal]; sets are
    center -/+ qhat * modulation; coverage counts samples entirely inside."""
    cal_scores = _t(cal_scores)
    qhats = _qhats_for_alphas(cal_scores, alphas)
    modulation = _t(modulation)
    center, target = _center_target(pred_residual, target_residual, qhats.dtype,
                                    qhats.device)
    cov = [filter_sims_joint((center - q * modulation, center + q * modulation),
                             target).float().mean() for q in qhats]
    return np.asarray(alphas), torch.stack(cov).cpu().numpy()


def marginal_cp(res_out_cal, res_pred_cal, pred_residual, target_residual=None,
                alphas=DEFAULT_ALPHAS, alpha: float = 0.1, mode: str = "aer+pre"):
    """Full marginal-CP block: scores, one-alpha sets, sweep, filter mask.

    mode 'aer+pre': scores = |res_out_cal - res_pred_cal|;
    mode 'pre':     scores = |res_pred_cal| (data-free)."""
    if mode == "aer+pre":
        scores = (_t(res_out_cal) - _t(res_pred_cal)).abs()
        sweep = marginal_coverage_sweep(scores, pred_residual, target_residual, alphas)
    elif mode == "pre":
        scores = _t(res_pred_cal).abs()
        sweep = marginal_coverage_sweep(scores, pred_residual, None, alphas)
    else:
        raise ValueError(f"unknown mode {mode}")
    qhat = calibrate(scores, scores.shape[0], alpha)
    if mode == "pre":
        sets = (-qhat, qhat)
        mask = filter_sims_within_bounds(-qhat, qhat, pred_residual, threshold=0.5)
    else:
        pr = _t(pred_residual)
        sets = (pr - qhat, pr + qhat)
        mask = None
    return {"scores": scores, "qhat": qhat, "sets": sets,
            "alphas": sweep[0], "coverage": sweep[1], "filter_mask": mask}


def joint_cp(res_out_cal, res_pred_cal, pred_residual, target_residual=None,
             alphas=DEFAULT_ALPHAS, alpha: float = 0.1, mode: str = "aer+pre",
             eps: float = 0.0, holdout_modulation: bool = False):
    """Full joint-CP block.

    mode 'aer+pre': modulation over (res_out - res_pred); mode 'pre':
    modulation over res_pred alone. `eps` is the caller-side modulation
    guard. `holdout_modulation=True` estimates the modulation on the first
    half of the calibration set and scores the second half, which restores
    the finite-sample guarantee that in-sample modulation breaks."""
    res_pred_cal = _t(res_pred_cal)
    res_out_cal = _t(res_out_cal) if res_out_cal is not None else None
    if holdout_modulation:
        n_half = res_pred_cal.shape[0] // 2
        mod_out = res_out_cal[:n_half] if res_out_cal is not None else None
        mod_pred = res_pred_cal[:n_half]
        score_out = res_out_cal[n_half:] if res_out_cal is not None else None
        score_pred = res_pred_cal[n_half:]
    else:
        mod_out = score_out = res_out_cal
        mod_pred = score_pred = res_pred_cal
    pred_residual = _t(pred_residual)
    if mode == "aer+pre":
        mod = modulation_func(mod_out, mod_pred) + eps
        scores = ncf_metric_joint(score_out, score_pred, mod)
        sweep = joint_coverage_sweep(scores, mod, pred_residual, target_residual, alphas)
        center = pred_residual
    else:
        mod = modulation_func(mod_pred, None) + eps
        scores = ncf_metric_joint(score_pred, None, mod)
        sweep = joint_coverage_sweep(scores, mod, pred_residual, None, alphas)
        center = torch.zeros_like(pred_residual)
    qhat = calibrate(scores, scores.shape[0], alpha)
    sets = (center - qhat * mod, center + qhat * mod)
    mask = filter_sims_joint(sets, pred_residual)
    return {"scores": scores, "modulation": mod, "qhat": qhat, "sets": sets,
            "alphas": sweep[0], "coverage": sweep[1], "filter_mask": mask}
