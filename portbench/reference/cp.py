"""Joint split conformal prediction over the physics residual, score 'pre'
(CP-PRE, arXiv 2502.04406, joint mode), in float64 on the residuals.

modulation: per-cell population std of the calibration residuals; score:
per-sample max over cells of |residual| / modulation; qhat: the calibration
score at sorted index ceil(level (n - 1)), level = ceil((n + 1)(1 - alpha)) / n
capped at 1 (the 'higher' quantile). A prediction is accepted when every
cell of its residual lies within +-qhat * modulation.
"""

from __future__ import annotations

import math

import torch


def quantile_index(n: int, alpha: float) -> int:
    level = min(math.ceil((n + 1) * (1 - alpha)) / n, 1.0)
    return math.ceil(level * (n - 1))


def calibrate(res_cal, alpha: float):
    """(qhat, modulation) from calibration residuals [n, *cells]."""
    r = res_cal.double()
    mod = torch.std(r, dim=0, correction=0)
    scores = scores_of(r, mod)
    qhat = torch.sort(scores).values[quantile_index(r.shape[0], alpha)]
    return qhat, mod


def scores_of(res, mod):
    """Per-sample max over cells of |res| / mod."""
    return (res.double().abs() / mod).reshape(res.shape[0], -1).amax(dim=1)
