"""Loss functions: relative Lp, MSE/MAE, heteroscedastic NLL, ELBO (port of
`cppre.train.losses`).

`LpLoss(size_average=False)` is the relative Lp loss of the FNO codebase
that every training script uses: per sample ||pred - target||_p /
||target||_p, summed (or averaged) over the batch.
"""

from __future__ import annotations

import torch

__all__ = ["lp_loss", "LpLoss", "mse", "mae", "nll", "elbo"]


def lp_loss(pred, target, p: int = 2, size_average: bool = False):
    """Relative Lp loss per sample: ||pred - target||_p / ||target||_p, then
    mean (size_average=True) or sum (False) over the batch."""
    b = pred.shape[0]
    diff_norms = torch.linalg.vector_norm((pred - target).reshape(b, -1), ord=p, dim=1)
    tgt_norms = torch.linalg.vector_norm(target.reshape(b, -1), ord=p, dim=1)
    rel = diff_norms / tgt_norms
    return rel.mean() if size_average else rel.sum()


class LpLoss:
    """Callable matching the reference class: LpLoss(size_average=False)."""

    def __init__(self, d: int = 2, p: int = 2, size_average: bool = True):
        self.d, self.p, self.size_average = d, p, size_average

    def __call__(self, pred, target):
        return lp_loss(pred, target, p=self.p, size_average=self.size_average)


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mae(pred, target):
    return torch.mean(torch.abs(pred - target))


def nll(mean, log_var, target):
    """Heteroscedastic Gaussian negative log-likelihood: mean over cells of
    0.5*(log var + (y-mu)^2/var)."""
    var = torch.exp(log_var)
    return torch.mean(0.5 * (log_var + (target - mean) ** 2 / var))


def elbo(likelihood, kl, batch_size):
    """ELBO = -(likelihood - KL)/batch."""
    return -(likelihood - kl) / batch_size
