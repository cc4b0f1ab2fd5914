"""Training loops: the AR train step, the epoch and `fit` (port of
`cppre.train.loops`).

Per batch the loss is the SUM over rollout chunks of loss_func(im, y_chunk),
backpropagated through the whole rollout; the gradients are clipped to a
global norm of 2.0 and Adam steps. The epoch also reports the
full-trajectory loss. The JAX package compiles the rollout as a `lax.scan`
under `jit`; here it is a Python loop. With `remat` (the default) each step
runs under `torch.utils.checkpoint` (non-reentrant), so the backward
recomputes a step's forward instead of keeping its activations: through
`models.fused.make_fused_train_apply`, every block forward then runs K4
twice per step, once forward and once in the recompute. A `remat_policy`
(`resolve_remat_policy`) saves some of a step's results instead, a
selective checkpoint: "dots" keeps every matrix product's output, so the
recompute re-runs none of them. Policies change what is recomputed, never
values. Through K4-K7 the contractions live inside the kernels, which the
dispatcher does not see, so a dots policy saves only the glue's products,
as `jax.checkpoint`'s policy does around cppre's `pallas_call`s.

An apply wrapped by `models.with_matmul_precision` or
`with_activation_dtype` carries its scope; the train step enters it around
the forward and the backward (the checkpoint recompute runs inside the
backward), so both run at the wrapped precision.

The optimizer is the counterpart of the optax chain
clip_by_global_norm -> adam(exponential_decay(staircase)):
`torch.optim.Adam`, a `StepLR(scheduler_step, gamma)` stepped once per
epoch (every `steps_per_epoch` optimizer steps, the optax transition of
`scheduler_step * steps_per_epoch`), and optax's clip rule
g * max_norm / ||g|| when ||g|| >= max_norm, the norm taken over the real
and imaginary parts of complex weights alike.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.fno import train_scope

__all__ = ["Optimizer", "TrainState", "make_optimizer", "rollout_loss", "make_train_step",
           "train_one_epoch_AR", "fit", "resolve_remat_policy"]


class Optimizer:
    """Adam with a per-epoch StepLR schedule and global-norm clipping."""

    def __init__(self, params, lr: float, scheduler_step: int, scheduler_gamma: float,
                 steps_per_epoch: int, grad_clip: float):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lr)
        self.schedule = torch.optim.lr_scheduler.StepLR(self.adam, scheduler_step,
                                                        scheduler_gamma)
        self.steps_per_epoch, self.grad_clip = steps_per_epoch, grad_clip
        self.count = 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip(self):
        """optax.clip_by_global_norm: g unchanged below the bound, else
        (g / ||g||) * max_norm. No host sync: the choice is a `where`."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return
        sq = [torch.sum(torch.view_as_real(g) ** 2) if g.is_complex() else torch.sum(g * g)
              for g in grads]
        norm = torch.sqrt(torch.stack(sq).sum())
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * self.grad_clip))

    def step(self):
        self.clip()
        self.adam.step()
        self.count += 1
        if self.count % self.steps_per_epoch == 0:
            self.schedule.step()


def make_optimizer(params, lr: float, scheduler_step: int = 100, scheduler_gamma: float = 0.5,
                   steps_per_epoch: int = 1, grad_clip: float = 2.0) -> Optimizer:
    """Adam + staircase decay every `scheduler_step` epochs + global-norm clip."""
    return Optimizer(params, lr, scheduler_step, scheduler_gamma, steps_per_epoch, grad_clip)


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: Optimizer
    apply_fn: Callable = None


# the aten matrix products a dots policy saves: all of them, or those
# without a batch dimension (jax's dots_with_no_batch_dims_saveable)
_DOTS = ("mm", "addmm", "bmm", "baddbmm", "matmul")
_DOTS_NO_BATCH = ("mm", "addmm")
# the accepted names: the short aliases and the jax.checkpoint_policies
# names they stand for, and jax's save-nothing and save-everything policies
_POLICY_NAMES = {"dots": _DOTS, "checkpoint_dots": _DOTS,
                 "dots_no_batch": _DOTS_NO_BATCH,
                 "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
                 "nothing_saveable": (), "everything_saveable": None}


def _save_ops(names):
    """A selective-checkpoint policy: save the outputs of the aten ops
    named in `names` (None: every op), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    ops = None if names is None else {getattr(torch.ops.aten, n).default for n in names}

    def policy(ctx, op, *args, **kwargs):
        if ops is None or op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def resolve_remat_policy(name):
    """A remat-policy spec -> a selective-checkpoint policy
    (`torch.utils.checkpoint.create_selective_checkpoint_contexts`'s
    `policy_fn_or_list`), or None: full recomputation, save nothing.

    Accepts None, a callable (passed through), the aliases "dots" and
    "dots_no_batch", or the jax names they stand for, "checkpoint_dots" and
    "dots_with_no_batch_dims_saveable", and "nothing_saveable" and
    "everything_saveable". cppre accepts any `jax.checkpoint_policies`
    name; the other names have no torch counterpart and raise ValueError."""
    if name is None or callable(name):
        return name
    if name not in _POLICY_NAMES:
        raise ValueError(f"unknown remat policy {name!r}; one of {sorted(_POLICY_NAMES)}, "
                         "None or a callable")
    return _save_ops(_POLICY_NAMES[name])


def _checkpointed(body, policy):
    """`body` under a non-reentrant checkpoint; with `policy`, a selective
    one that saves what the policy keeps."""
    if policy is None:
        return functools.partial(checkpoint, body, use_reentrant=False)
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return functools.partial(checkpoint, body, use_reentrant=False,
                             context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                          policy))


def rollout_loss(apply_fn, xx, yy, step: int, T_out: int, loss_func, remat: bool = True,
                 remat_policy=None):
    """Sum over chunks of loss_func(im, y_chunk) along an AR rollout of
    `apply_fn` (x -> next `step` frames). Returns (total_chunk_loss, pred
    [..., T_out]). With `remat` each step is checkpointed, selectively
    under `remat_policy` (`resolve_remat_policy`)."""
    n = T_out // step
    if n == 1:
        # single-shot (step == T_out): no AR carry, also for step > T_in
        im = apply_fn(xx)
        return loss_func(im, yy[..., :step]), im

    def body(xx, y):
        im = apply_fn(xx)
        return im, loss_func(im, y)

    step_fn = _checkpointed(body, resolve_remat_policy(remat_policy)) if remat else body
    total, preds = 0.0, []
    for t in range(n):
        y = yy[..., t * step:(t + 1) * step]
        im, loss = step_fn(xx, y)
        total = total + loss
        preds.append(im)
        xx = torch.cat((xx[..., step:], im), dim=-1)
    return total, torch.cat(preds, dim=-1)


def make_train_step(apply_fn, optimizer: Optimizer, step: int, T_out: int, loss_func,
                    remat: bool = True, remat_policy=None):
    """(xx, yy) -> (loss, full_loss): one optimizer step on the rollout loss;
    full_loss is loss_func over the whole predicted trajectory. The forward
    and the backward run inside `apply_fn`'s scope (`models.train_scope`)."""
    resolve_remat_policy(remat_policy)    # refuse an unknown name here

    def train_step(xx, yy):
        optimizer.zero_grad()
        with train_scope(apply_fn):
            loss, pred = rollout_loss(apply_fn, xx, yy, step, T_out, loss_func, remat=remat,
                                      remat_policy=remat_policy)
            loss.backward()
        optimizer.step()
        with torch.no_grad():
            full_loss = loss_func(pred, yy)
        return loss.detach(), full_loss

    return train_step


@torch.no_grad()
def _eval_loss(apply_fn, xx, yy, step, T_out, loss_func):
    _, pred = rollout_loss(apply_fn, xx, yy, step, T_out, loss_func, remat=False)
    return loss_func(pred, yy)


def train_one_epoch_AR(state: TrainState, train_step, train_a, train_u, test_a, test_u,
                       generator: torch.Generator, batch_size: int, step: int, T_out: int,
                       loss_func):
    """One epoch over shuffled minibatches; returns (state, train_loss, test_loss).

    The permutation comes from `generator` (a CPU `torch.Generator`). Losses
    are the summed full-trajectory losses over the epoch: divide by
    n_train / n_test at the logging site, as the reference does."""
    n = train_a.shape[0]
    perm = torch.randperm(n, generator=generator).to(train_a.device)
    train_loss = 0.0
    for i in range(0, n - batch_size + 1, batch_size):
        idx = perm[i:i + batch_size]
        _, full = train_step(train_a[idx], train_u[idx])
        train_loss += float(full)
    test_loss = float(_eval_loss(state.apply_fn, test_a, test_u, step, T_out, loss_func))
    return state, train_loss, test_loss


def fit(model_apply, model, train_a, train_u, test_a, test_u, *, epochs: int, batch_size: int,
        step: int, T_out: int, loss_func, lr: float = 5e-3, scheduler_step: int = 100,
        scheduler_gamma: float = 0.5, seed: int = 0, verbose: bool = False, remat: bool = True,
        remat_policy=None):
    """Train for `epochs` epochs through `model_apply` (a callable
    x -> model output that differentiates into `model`'s parameters, e.g.
    `model` itself or `models.fused.make_fused_train_apply(model)`).

    Trains `model` in place. Returns (model.state_dict(), losses) with
    losses a list of per-epoch (train, test) losses per sample."""
    steps_per_epoch = max(train_a.shape[0] // batch_size, 1)
    opt = make_optimizer(model.parameters(), lr, scheduler_step, scheduler_gamma,
                         steps_per_epoch)
    state = TrainState(model, opt, model_apply)
    train_step = make_train_step(model_apply, opt, step, T_out, loss_func, remat=remat,
                                 remat_policy=remat_policy)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for ep in range(epochs):
        state, train_loss, test_loss = train_one_epoch_AR(
            state, train_step, train_a, train_u, test_a, test_u, gen, batch_size, step, T_out,
            loss_func)
        losses.append((train_loss / train_a.shape[0], test_loss / test_a.shape[0]))
        if verbose:
            print(f"epoch {ep}: train {losses[-1][0]:.6f} test {losses[-1][1]:.6f}")
    return model.state_dict(), losses
