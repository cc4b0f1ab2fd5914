"""Autoregressive rollout (port of `cppre.train.rollout`).

The JAX package compiles the rollout as a `lax.scan`; PyTorch runs eagerly,
so here it is the plain loop of the reference:

    for t in range(0, T_out, step):
        im = model(xx)
        pred = cat(pred, im, -1)
        xx = cat(xx[..., step:], im, -1)

`validation_AR` evaluates the whole batch in one call per step, which keeps
calibration and prediction samples on identical numerics when the caller
rolls them out together.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["autoregressive_rollout", "validation_AR"]


def autoregressive_rollout(apply_fn: Callable, xx, step: int, T_out: int):
    """Roll `apply_fn` (x -> next `step` frames on the last axis) out to T_out.

    xx: [..., T_in] initial window. Returns pred [..., T_out]. T_out must be
    divisible by step.
    """
    if T_out % step != 0:
        raise ValueError(f"T_out={T_out} not divisible by step={step}")
    n = T_out // step
    if n == 1:
        return apply_fn(xx)
    preds = []
    for _ in range(n):
        im = apply_fn(xx)
        preds.append(im)
        xx = torch.cat((xx[..., step:], im), dim=-1)
    return torch.cat(preds, dim=-1)


def validation_AR(apply_fn: Callable, test_a, test_u, step: int, T_out: int):
    """Rollout + MSE/MAE metrics. Returns (pred_set, mse, mae) with 0-d
    tensors for the metrics."""
    pred = autoregressive_rollout(apply_fn, test_a, step, T_out)
    mse = torch.mean((pred - test_u) ** 2)
    mae = torch.mean(torch.abs(pred - test_u))
    return pred, mse, mae
