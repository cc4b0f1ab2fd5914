"""UQ model variants: MC-dropout, variational-Bayes last layer, MLE heads
(port of `cppre.models.variants`).

* Dropout FNO: `FNO2d(dropout_rate=0.1)`; MC sampling keeps dropout live
  by calling the model with `deterministic=False` and a `torch.Generator`.
* Bayesian FNO: `FNO2dBayesian`, FNO2d with variational `BayesDense`
  projection layers (weight_mu ~ U(+-1/sqrt(in)), weight_log_sigma =
  log(prior_sigma)) and the closed-form KL to N(prior_mu, prior_sigma).
  A draw of the head, w = mu + exp(log_sigma) * eps with eps from a
  `torch.Generator` (`sample_head`), is two plain layers: the kernels take
  it in place of the model's projection (`models.fused`'s `head=`), K5 in
  inference, K7 differentiating the drawn weights in training, and
  autograd carries their gradients on to mu and log_sigma.
* MLE FNO: the base FNO with `step*2` outputs, channel 0 the mean and
  channel 1 the log-variance.

Layouts are torch's: a BayesDense's weight_mu and weight_log_sigma are
[out, in] (cppre's [in, out] transposed; `utils.jax_params.
fno2d_bayes_from_jax` carries them over).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fno import HEAD_HIDDEN, FNO2d

__all__ = [
    "BayesDense",
    "Drawn",
    "FNO2dBayesian",
    "make_dropout_fno",
    "make_mle_fno",
    "bayes_kl_loss",
    "mc_dropout_apply",
]


class Drawn(NamedTuple):
    """One draw of a variational layer: weight [out, in] and bias [out]."""

    weight: torch.Tensor
    bias: torch.Tensor


class BayesDense(nn.Module):
    """Variational linear layer with independent Gaussian weights."""

    def __init__(self, in_features: int, features: int, prior_mu: float = 0.0,
                 prior_sigma: float = 0.1, generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, features
        self.prior_mu, self.prior_sigma = prior_mu, prior_sigma
        stdv = 1.0 / math.sqrt(in_features)
        log_sigma = math.log(prior_sigma)
        self.weight_mu = nn.Parameter(
            torch.empty(features, in_features).uniform_(-stdv, stdv, generator=generator))
        self.weight_log_sigma = nn.Parameter(torch.full((features, in_features), log_sigma))
        self.bias_mu = nn.Parameter(
            torch.empty(features).uniform_(-stdv, stdv, generator=generator))
        self.bias_log_sigma = nn.Parameter(torch.full((features,), log_sigma))

    def sample(self, generator=None, eps=None) -> Drawn:
        """w = mu + exp(log_sigma) * eps for weight and bias; eps is
        (eps_weight [out, in], eps_bias [out]) or drawn from `generator`
        (on the layer's device)."""
        if eps is None:
            dev = self.weight_mu.device
            eps = (torch.randn(self.weight_mu.shape, generator=generator, device=dev),
                   torch.randn(self.bias_mu.shape, generator=generator, device=dev))
        return Drawn(self.weight_mu + torch.exp(self.weight_log_sigma) * eps[0],
                     self.bias_mu + torch.exp(self.bias_log_sigma) * eps[1])

    def forward(self, x, generator=None, eps=None):
        w = self.sample(generator, eps)
        return F.linear(x, w.weight, w.bias)


class FNO2dBayesian(FNO2d):
    """FNO_multi2d with Bayesian projection layers (Bayes-last-layer VI).

    The same body as FNO2d (dropout-free); fc1_time and fc2_time are
    `BayesDense` with prior N(0, prior_sigma). A forward draws one posterior
    sample of the head from `generator` unless `head` (a `sample_head`
    draw) is given; `deterministic` is accepted as cppre's is and ignored.
    """

    def __init__(self, T_in, step, modes1, modes2, num_vars, width_time,
                 prior_sigma: float = 0.1, *, device="cuda", generator=None):
        self.prior_sigma = prior_sigma
        super().__init__(T_in, step, modes1, modes2, num_vars, width_time, device=device,
                         generator=generator)

    def _make_head(self, width_time, step, g):
        self.fc1_time = BayesDense(width_time, HEAD_HIDDEN, prior_sigma=self.prior_sigma,
                                   generator=g)
        self.fc2_time = BayesDense(HEAD_HIDDEN, step, prior_sigma=self.prior_sigma, generator=g)

    def head_layers(self):
        raise ValueError("this model's head is drawn: pass head=model.sample_head(...)")

    def head_width(self) -> int:
        return self.fc1_time.weight_mu.shape[0]

    def sample_head(self, generator=None, eps=None):
        """One posterior draw of the head: (Drawn fc1, Drawn fc2). `eps`
        is {"fc1_time": (eps_w, eps_b), "fc2_time": (eps_w, eps_b)} or
        drawn from `generator`, fc1's weight, fc1's bias, fc2's weight, then
        fc2's bias. The draw is differentiable in mu and log_sigma."""
        eps = eps or {}
        return (self.fc1_time.sample(generator, eps.get("fc1_time")),
                self.fc2_time.sample(generator, eps.get("fc2_time")))

    def forward(self, x, deterministic: bool = True, generator=None, head=None):
        fc1, fc2 = head if head is not None else self.sample_head(generator)
        z = F.gelu(F.linear(self.body(x), fc1.weight, fc1.bias))
        return F.linear(z, fc2.weight, fc2.bias)


def make_dropout_fno(T_in, step, modes1, modes2, num_vars, width_time,
                     dropout_rate: float = 0.1, *, device="cuda", generator=None) -> FNO2d:
    """FNO_multi2d_Dropout factory."""
    return FNO2d(T_in, step, modes1, modes2, num_vars, width_time, dropout_rate=dropout_rate,
                 device=device, generator=generator)


def make_mle_fno(T_in, step, modes1, modes2, num_vars, width_time, *, device="cuda",
                 generator=None) -> FNO2d:
    """MLE (heteroscedastic) FNO: step*2 outputs (mean, log-var)."""
    return FNO2d(T_in, step * 2, modes1, modes2, num_vars, width_time, device=device,
                 generator=generator)


def bayes_kl_loss(params, prior_mu: float = 0.0, prior_sigma: float = 0.1,
                  reduction: str = "mean"):
    """Closed-form KL(q || N(prior_mu, prior_sigma)) summed over every
    (weight|bias)_mu / _log_sigma pair of `params` (a module, or a mapping
    of parameter names to tensors), averaged over their elements with
    reduction "mean"."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    prior_log_sigma = math.log(prior_sigma)
    total, count = 0.0, 0
    for key, mu in named.items():
        ls_key = key[:-len("_mu")] + "_log_sigma" if key.endswith("_mu") else None
        if ls_key in named:
            log_sigma = named[ls_key]
            kl = prior_log_sigma - log_sigma + (
                torch.exp(log_sigma) ** 2 + (mu - prior_mu) ** 2) / (2 * prior_sigma**2) - 0.5
            total = total + torch.sum(kl)
            count += kl.numel()
    if reduction == "mean" and count:
        return total / count
    return total


def mc_dropout_apply(model, x, generator, samples: int):
    """MC-dropout ensemble forward: `samples` forwards with dropout live,
    each with fresh masks from `generator`, one after another. Returns
    [samples, ...] stacked predictions."""
    return torch.stack([model(x, deterministic=False, generator=generator)
                        for _ in range(samples)])
