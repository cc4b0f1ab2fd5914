"""Per-UQ-method validation rollouts -> (mean, std/qhat, mse, mae) (port of
`cppre.uq.validation`).

The model holds its weights, so unlike cppre's validators these take no
`params`: an ensemble is a list of models, and SWAG writes its draws into
`model` in turn and restores its weights after. Each rollout covers the
whole test batch; MC samples and ensemble members run one after another,
so one rollout's activations are alive at a time.

Rollouts of a dropout-free FNO2d (Deterministic, AER, PRE, ensemble
members, SWAG draws, MLE) go through `models.fused.make_fused_apply`, the
kernels K4 and K5 on the card (their plain versions on the CPU); a
Bayesian draw reaches K5 as the head of that apply. MC dropout runs the
module's own forward with dropout live: each sample draws one set of masks
from `generator` and keeps it for every step of its rollout, as cppre's
per-sample key does. On the card that forward is a CUDA graph
(`_DropoutForward`): the eager forward is bound by its ~300 launches.
"""

from __future__ import annotations

import torch

from ..cp.inductive import calibrate
from ..models.fused import make_fused_apply
from ..train.rollout import autoregressive_rollout, validation_AR

__all__ = [
    "validation_deterministic",
    "validation_dropout",
    "validation_ensemble",
    "validation_bayesian",
    "validation_swag",
    "validation_mle",
    "validation_aer",
    "validation_pre",
    "validation_aer_scores",
    "validation_pre_scores",
]


def _metrics(pred, test_u):
    return torch.mean((pred - test_u) ** 2), torch.mean(torch.abs(pred - test_u))


def _mean_std(rollouts, test_u):
    preds = torch.stack(rollouts)
    mean, std = preds.mean(dim=0), preds.std(dim=0, correction=0)
    return (mean, std) + _metrics(mean, test_u)


class _DropoutForward:
    """`fwd(x, state)`: `model(x)` with dropout live, its masks drawn from
    `generator` set to `state` (a `get_state()`), so calls with one state
    draw the same masks. On the CPU the module's forward; on the card the
    first call at a shape runs it eagerly on a side stream, the second
    captures it as a CUDA graph with `generator` registered, and later
    calls replay that graph: each replay draws from the generator's state
    at the replay, at the offsets the eager forward's draws take, so the
    masks and the generator's state after the call are the eager
    forward's."""

    def __init__(self, model, generator):
        self.model, self.generator = model, generator
        self.graphs, self.warm = {}, set()

    def _eager(self, x):
        return self.model(x, deterministic=False, generator=self.generator)

    def __call__(self, x, state):
        self.generator.set_state(state)
        if not x.is_cuda:
            return self._eager(x)
        key = tuple(x.shape)
        if key not in self.graphs:
            if key not in self.warm:
                self.warm.add(key)
                here = torch.cuda.current_stream(x.device)
                side = torch.cuda.Stream(x.device)
                side.wait_stream(here)
                with torch.cuda.stream(side):
                    out = self._eager(x)
                here.wait_stream(side)
                return out
            static_x, graph = x.clone(), torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            with torch.cuda.graph(graph):
                static_y = self._eager(static_x)
            self.graphs[key] = (graph, static_x, static_y)
        graph, static_x, static_y = self.graphs[key]
        static_x.copy_(x)
        self.generator.set_state(state)
        graph.replay()
        return static_y.clone()


@torch.no_grad()
def validation_deterministic(model, test_a, test_u, step, T_out):
    """The plain rollout through K4/K5: (pred, mse, mae), cppre's
    `validation_AR` of `model.apply`."""
    return validation_AR(make_fused_apply(model), test_a, test_u, step, T_out)


@torch.no_grad()
def validation_dropout(model, test_a, test_u, step, T_out, samples, generator):
    """MC dropout: dropout live at eval, one mask set per sample (one
    `_DropoutForward`, so on the card one graph, for all of them)."""
    fwd, rollouts = _DropoutForward(model, generator), []
    for _ in range(samples):
        state = generator.get_state()
        rollouts.append(autoregressive_rollout(lambda x, s=state: fwd(x, s), test_a, step,
                                               T_out))
    return _mean_std(rollouts, test_u)


@torch.no_grad()
def validation_bayesian(model, test_a, test_u, step, T_out, samples, generator):
    """VI posterior sampling: one head draw from `generator` per sample,
    rolled out through K4 and K5."""
    rollouts = [autoregressive_rollout(
        make_fused_apply(model, head=model.sample_head(generator)), test_a, step, T_out)
        for _ in range(samples)]
    return _mean_std(rollouts, test_u)


@torch.no_grad()
def validation_ensemble(models, test_a, test_u, step, T_out):
    """Deep ensemble: one rollout per member model."""
    rollouts = [autoregressive_rollout(make_fused_apply(m), test_a, step, T_out)
                for m in models]
    return _mean_std(rollouts, test_u)


@torch.no_grad()
def validation_swag(model, swag, test_a, test_u, step, T_out, samples, generator,
                    scale: float = 0.5):
    """SWAG: draw a parameter vector, write it into `model`, roll out;
    `model`'s own weights come back afterwards."""
    keep = swag.flatten(model)
    rollouts = []
    try:
        for _ in range(samples):
            swag.load_into(model, swag.sample_vector(generator, scale))
            rollouts.append(autoregressive_rollout(make_fused_apply(model), test_a, step,
                                                   T_out))
    finally:
        swag.load_into(model, keep)
    return _mean_std(rollouts, test_u)


@torch.no_grad()
def validation_mle(model, test_a, test_u, step, T_out):
    """Heteroscedastic MLE: the model emits (mean, log-var) pairs on the last
    axis (2*step channels); the rollout feeds back only the mean. Returns
    (means, var, mse, mae)."""
    apply_fn = make_fused_apply(model)
    means, log_vars, x = [], [], test_a
    for _ in range(T_out // step):
        out = apply_fn(x)
        mean, log_var = out[..., :step], out[..., step:]
        x = torch.cat((x[..., step:], mean), dim=-1)
        means.append(mean)
        log_vars.append(log_var)
    means, var = torch.cat(means, dim=-1), torch.exp(torch.cat(log_vars, dim=-1))
    return (means, var) + _metrics(means, test_u)


def _rollout(model, test_a, test_u, step, T_out):
    """The fused rollout, cropped to test_u's batch (a padded tail of
    test_a never enters the scores)."""
    pred = autoregressive_rollout(make_fused_apply(model), test_a, step, T_out)
    return pred[:test_u.shape[0]]


def _pre_scores(pre, pred):
    return torch.abs(pre.residual(pred.permute(0, 1, 4, 2, 3)))


def _aer_from_rollout(pred, test_u, alpha):
    qhat = calibrate(torch.abs(pred - test_u), pred.shape[0], alpha)
    return (pred, qhat) + _metrics(pred, test_u)


def _pre_from_rollout(pred, test_u, alpha, pre):
    qhat = calibrate(_pre_scores(pre, pred), pred.shape[0], alpha)
    return (pred, qhat) + _metrics(pred, test_u)


@torch.no_grad()
def validation_aer(model, test_a, test_u, step, T_out, alpha):
    """Absolute-error-residual CP: qhat from |pred - truth|."""
    return _aer_from_rollout(_rollout(model, test_a, test_u, step, T_out), test_u, alpha)


@torch.no_grad()
def validation_pre(model, test_a, test_u, step, T_out, alpha, pre):
    """Physics-residual CP: qhat from |PRE(pred)|. `pre` has
    `.residual(fields)` over [B, Nvar, Nt, Nx, Ny] (`uq.data_loaders`' PREs
    launch their kernel on the card)."""
    return _pre_from_rollout(_rollout(model, test_a, test_u, step, T_out), test_u, alpha, pre)


@torch.no_grad()
def validation_aer_scores(model, test_a, test_u, step, T_out):
    """Chunkable AER leg: per-sim scores without the quantile, which the
    caller takes over the concatenated pieces (the batch couples only
    there)."""
    pred = _rollout(model, test_a, test_u, step, T_out)
    return (pred, torch.abs(pred - test_u)) + _metrics(pred, test_u)


@torch.no_grad()
def validation_pre_scores(model, test_a, test_u, step, T_out, pre):
    """Chunkable PRE leg (see `validation_aer_scores`)."""
    pred = _rollout(model, test_a, test_u, step, T_out)
    return (pred, _pre_scores(pre, pred)) + _metrics(pred, test_u)
