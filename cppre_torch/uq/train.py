"""Training for the UQ variants: ELBO (Bayesian), NLL (MLE), SWAG (port of
`cppre.uq.train`).

ELBO = -(likelihood - KL)/batch with likelihood = -sum-MSE and the
mean-reduced KL of the Bayes layers, added at every rollout step; NLL on
(mean, log-var) channel pairs; SWAG collects a snapshot each epoch past a
threshold at a constant learning rate.

The train steps run one optimizer step (`train.loops.Optimizer`: Adam,
StepLR, global-norm clip) on the loss of an autoregressive rollout whose
steps are checkpointed, as `train.loops.rollout_loss`'s are. `apply_fn` is
the model or `models.fused.make_fused_train_apply(model)` (K4/K5 forward,
K6/K7 backward on the card). A Bayesian step draws each rollout step's eps
from a `torch.Generator` before the checkpointed body, so the recompute
sees the same head. Each step runs its forward and backward inside
`apply_fn`'s precision scope (`models.train_scope`).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.fno import train_scope
from ..models.swag import SWAG
from ..models.variants import bayes_kl_loss
from ..train.loops import TrainState, make_optimizer

__all__ = ["nll_chunk_loss", "make_bayesian_train_step", "make_mle_train_step",
           "bayesian_rollout_loss", "mle_rollout_loss", "fit_swag"]


def nll_chunk_loss(pred, target):
    """Heteroscedastic NLL for a (mean, log-var) chunk: pred [..., 2*s]
    against target [..., s]."""
    s = target.shape[-1]
    mean, log_var = pred[..., :s], pred[..., s:]
    return torch.mean((log_var + (mean - target) ** 2 / torch.exp(log_var)) / 2)


def mle_rollout_loss(apply_fn, xx, yy, step: int, T_out: int):
    """Sum over rollout steps of `nll_chunk_loss`, feeding back the mean."""

    def body(x, y):
        out = apply_fn(x)
        return out[..., :step], nll_chunk_loss(out, y)

    total = 0.0
    for t in range(T_out // step):
        mean, loss = checkpoint(body, xx, yy[..., t * step:(t + 1) * step],
                                use_reentrant=False)
        total = total + loss
        xx = torch.cat((xx[..., step:], mean), dim=-1)
    return total


def make_mle_train_step(apply_fn, optimizer, step: int, T_out: int):
    """(xx, yy) -> loss: one optimizer step on `mle_rollout_loss`; the model
    emits 2*step channels and feeds back the mean."""

    def train_step(xx, yy):
        optimizer.zero_grad()
        with train_scope(apply_fn):
            loss = mle_rollout_loss(apply_fn, xx, yy, step, T_out)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def bayesian_rollout_loss(apply_fn, model, xx, yy, step: int, T_out: int, eps,
                          prior_sigma: float = 0.1):
    """Sum over rollout steps of -(likelihood - KL)/batch, each step's head
    drawn from its own `eps` (a list of `FNO2dBayesian.sample_head` eps
    dicts, one a step); `apply_fn(x, head=...)` runs the model with it."""
    bs = xx.shape[0]
    kl = bayes_kl_loss(model, prior_sigma=prior_sigma)

    def body(x, y, e):
        im = apply_fn(x, head=model.sample_head(eps=e))
        return im, -(-torch.sum((im - y) ** 2) - kl) / bs

    total = 0.0
    for t in range(T_out // step):
        im, loss = checkpoint(body, xx, yy[..., t * step:(t + 1) * step], eps[t],
                              use_reentrant=False)
        total = total + loss
        xx = torch.cat((xx[..., step:], im), dim=-1)
    return total


def _draw_eps(model, generator):
    """One head draw's eps, in `sample_head`'s order."""
    out = {}
    for name in ("fc1_time", "fc2_time"):
        layer = getattr(model, name)
        dev = layer.weight_mu.device
        out[name] = (torch.randn(layer.weight_mu.shape, generator=generator, device=dev),
                     torch.randn(layer.bias_mu.shape, generator=generator, device=dev))
    return out


def make_bayesian_train_step(apply_fn, optimizer, step: int, T_out: int,
                             prior_sigma: float = 0.1, *, model):
    """(xx, yy, generator) -> loss: one optimizer step on the ELBO rollout
    loss of `model` (an `FNO2dBayesian`), a fresh head drawn from
    `generator` at every rollout step."""

    def train_step(xx, yy, generator):
        eps = [_draw_eps(model, generator) for _ in range(T_out // step)]
        optimizer.zero_grad()
        with train_scope(apply_fn):
            loss = bayesian_rollout_loss(apply_fn, model, xx, yy, step, T_out, eps, prior_sigma)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def fit_swag(apply_fn, model, train_a, train_u, *, epochs: int, batch_size: int, step: int,
             T_out: int, loss_func, lr: float = 5e-3, swa_start: int | None = None,
             max_num_models: int = 20, seed: int = 0) -> SWAG:
    """Train `model` in place with a constant learning rate, collecting a
    SWAG snapshot each epoch >= swa_start. The permutation comes from a CPU
    `torch.Generator` seeded with `seed`."""
    from ..train.loops import make_train_step, train_one_epoch_AR

    if swa_start is None:
        swa_start = max(epochs - max_num_models, epochs // 2)
    steps_per_epoch = max(train_a.shape[0] // batch_size, 1)
    opt = make_optimizer(model.parameters(), lr, scheduler_step=epochs + 1, scheduler_gamma=1.0,
                         steps_per_epoch=steps_per_epoch)
    state = TrainState(model, opt, apply_fn)
    train_step = make_train_step(apply_fn, opt, step, T_out, loss_func)
    swag = SWAG(model, max_num_models=max_num_models)
    gen = torch.Generator().manual_seed(seed)
    for ep in range(epochs):
        state, _, _ = train_one_epoch_AR(state, train_step, train_a, train_u, train_a[-2:],
                                         train_u[-2:], gen, batch_size, step, T_out, loss_func)
        if ep >= swa_start:
            swag.collect_model(model)
    return swag
