"""The active-learning loop (port of `cppre.al.loop`).

Per iteration: draw a fresh LHS candidate pool, roll the surrogate out from
the candidates' initial conditions, compute their residuals, acquire the
most informative parameters (CP, CP_MARGINAL, PRE or RAND), run the
numerical solver on them, append them to the training set, fine-tune and
evaluate the test MSE.

`model` is trained in place: there is no `params` argument, and the loop
returns `model.state_dict()`. A 2-D FNO rolls out through kernels K4/K5
(`models.make_fused_apply`) and fine-tunes through K4-K7
(`models.make_fused_train_apply`), the port's default route; an FNO1d
through its module.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..experiments.common import sample_params
from ..models import FNO2d, make_fused_apply, make_fused_train_apply
from ..train.loops import fit
from ..train.losses import mse
from ..train.rollout import autoregressive_rollout, validation_AR
from .acquisition import acquire_cp, acquire_cp_marginal, acquire_pre, acquire_rand

__all__ = ["active_learning_loop"]


def _applies(model):
    """(rollout apply, fine-tune apply) of `model`."""
    if isinstance(model, FNO2d):
        return make_fused_apply(model), make_fused_train_apply(model)
    return model, model


def active_learning_loop(
    *,
    acq_func: str,                       # 'CP' | 'CP_MARGINAL' | 'PRE' | 'RAND'
    model,
    gen_fields: Callable,                # design [n, d] -> (a, u) FNO tensors
    residual_of: Callable,               # rollout prediction -> residual
    lb, ub,
    train_a, train_u,                    # the initial training set
    test_a, test_u,
    cal_scores=None, modulation=None,    # joint-CP acquisition (per-sample scores)
    cal_scores_marginal=None,            # marginal-CP acquisition (per-cell scores)
    n_iterations: int = 5,
    n_pred: int = 100,
    alpha: float = 0.5,
    epochs: int = 100,
    batch_size: int = 10,
    step: int = 1,
    T_out: int = 20,
    loss_func=None,
    lr: float = 1e-3,
    seed: int = 0,
    verbose: bool = True,
    train_precision: str = "highest",
):
    """Returns (model.state_dict(), test_mse_history, sims_sampled_history)."""
    if train_precision != "highest":
        raise NotImplementedError(
            f"train_precision={train_precision!r} (bf16 activations or matmul precision) "
            "waits for the port's training options (ROADMAP Queue 1 item 8); the port "
            "trains in full float32 ('highest')")
    loss_func = loss_func or mse
    roll_apply, train_apply = _applies(model)
    test_mse, sims_sampled = [], []

    def rollout_mse():
        with torch.no_grad():
            return float(validation_AR(roll_apply, test_a, test_u, step, T_out)[1])

    test_mse.append(rollout_mse())
    for ii in range(n_iterations):
        pool = sample_params(lb, ub, n_pred, seed=seed * 100 + ii)
        pool_a, _ = gen_fields(pool)
        with torch.no_grad():
            pred_residual = residual_of(autoregressive_rollout(roll_apply, pool_a, step, T_out))

        if acq_func == "CP":
            chosen = acquire_cp(pool, pred_residual, cal_scores, modulation, alpha)
        elif acq_func == "CP_MARGINAL":
            if cal_scores_marginal is None:
                raise ValueError(
                    "CP_MARGINAL needs cal_scores_marginal (per-cell |residual| "
                    "scores, e.g. res_cal.abs()); the joint cal_scores are "
                    "per-sample sup-norms and would give a scalar qhat")
            chosen = acquire_cp_marginal(pool, pred_residual, cal_scores_marginal, alpha)
        elif acq_func == "PRE":
            chosen = acquire_pre(pool, pred_residual, alpha)
        elif acq_func == "RAND":
            chosen = acquire_rand(pool, alpha, seed=seed * 100 + ii)
        else:
            raise ValueError(f"unknown acquisition {acq_func}")
        if len(chosen) == 0:
            sims_sampled.append(0)
            test_mse.append(test_mse[-1])
            if verbose:
                print(f"iter {ii}: nothing acquired, skipping")
            continue

        new_a, new_u = gen_fields(chosen)
        train_a = torch.cat((train_a, new_a))
        train_u = torch.cat((train_u, new_u))
        fit(train_apply, model, train_a, train_u, test_a[:5], test_u[:5], epochs=epochs,
            batch_size=batch_size, step=step, T_out=T_out, loss_func=loss_func, lr=lr,
            seed=seed + ii)

        test_mse.append(rollout_mse())
        sims_sampled.append(int(len(chosen)))
        if verbose:
            print(f"iter {ii}: sampled {len(chosen)} sims, test MSE {test_mse[-1]:.3e}")

    return model.state_dict(), test_mse, sims_sampled
