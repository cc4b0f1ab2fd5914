"""Physics-informed training driver (port of `cppre.pi.train`).

The PI fine-tuning loop: an autoregressive rollout of T_out // step
checkpointed steps (`train.rollout.autoregressive_rollout` over
`torch.utils.checkpoint`, non-reentrant), the PI/PISL
loss on the prediction, then Adam with its staircase schedule and global
norm clip (`train.loops.make_optimizer`), or L-BFGS. `loss_on='last'`
replicates the reference's quirk of penalising only the final rollout
chunk; 'full' penalises the whole trajectory. Unlike `train.loops.fit`,
the loss sits at the end of the rollout, so its gradient reaches the
weights only through the autoregressive carry.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..train.loops import make_optimizer
from ..train.rollout import autoregressive_rollout

__all__ = ["finetune_physics_informed"]


def finetune_physics_informed(apply_fn, model, train_a, train_u, *, loss_fn: Callable,
                              epochs: int, batch_size: int, step: int, T_out: int,
                              lr: float = 5e-3, scheduler_step: int = 100,
                              scheduler_gamma: float = 0.5, loss_on: str = "full",
                              optimizer: str = "Adam", seed: int = 0, verbose: bool = False):
    """Train `model` in place through `apply_fn` (x -> the next `step`
    frames, differentiable into `model`'s parameters: `model` itself or
    `models.make_fused_train_apply(model)`) on loss_fn(pred, target) over
    FNO-layout tensors; the target may be unused (pure PI). Returns
    (model.state_dict(), losses), as `train.loops.fit` does, with losses
    the mean batch loss of each epoch.

    `optimizer="LBFGS"` is cppre's `optax.lbfgs(learning_rate=1.0)` as
    `torch.optim.LBFGS(lr=1.0, max_iter=1, history_size=10,
    line_search_fn="strong_wolfe")`: one update a batch, its line search
    evaluating the loss as often as it needs. The batches' permutation comes
    from a `torch.Generator` seeded with `seed`."""
    if loss_on == "last" and step < 3:
        # fno_chunk_residual crops the time axis by 1 per side: a last chunk
        # of step < 3 frames leaves an empty axis, whose mean is NaN, which
        # would silently NaN the parameters
        raise ValueError(
            f"loss_on='last' needs step >= 3 frames for the residual's time "
            f"crop (got step={step}); use loss_on='full'")
    n = train_a.shape[0]
    if optimizer == "LBFGS":
        opt = torch.optim.LBFGS(model.parameters(), lr=1.0, max_iter=1, history_size=10,
                                line_search_fn="strong_wolfe")
    else:
        opt = make_optimizer(model.parameters(), lr, scheduler_step, scheduler_gamma,
                             max(n // batch_size, 1))

    def loss_of(xx, yy):
        full = autoregressive_rollout(lambda x: checkpoint(apply_fn, x, use_reentrant=False),
                                      xx, step, T_out)
        if loss_on == "last":
            return loss_fn(full[..., -step:], yy[..., -step:])
        return loss_fn(full, yy)

    def train_step(xx, yy):
        def closure():
            opt.zero_grad()
            loss = loss_of(xx, yy)
            loss.backward()
            return loss

        if optimizer == "LBFGS":
            return opt.step(closure).detach()
        loss = closure()
        opt.step()
        return loss.detach()

    gen = torch.Generator().manual_seed(seed)
    starts = range(0, n - batch_size + 1, batch_size)
    losses = []
    for ep in range(epochs):
        perm = torch.randperm(n, generator=gen).to(train_a.device)
        ep_loss = 0.0
        for i in starts:
            idx = perm[i:i + batch_size]
            ep_loss += float(train_step(train_a[idx], train_u[idx]))
        losses.append(ep_loss / max(len(starts), 1))
        if verbose:
            print(f"PI epoch {ep}: loss {ep_loss:.6e}")
    return model.state_dict(), losses
