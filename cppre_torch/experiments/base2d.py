"""Shared 2-D experiment engine: normalize -> train FNO -> rollout -> PRE -> CP
(port of `cppre.experiments.base2d`).

`run_2d_cp` trains the FNO surrogate in-script (or takes a state dict in
`params` to skip training), rolls the calibration and prediction samples
out in ONE batched call, takes the residuals of truth and prediction, and
runs joint or marginal conformal calibration with the alpha sweep. With
`fused_train` (the default) the training runs kernels K4/K5 forward and
K6/K7 backward (`models.fused.make_fused_train_apply`), else plain autograd
through `FNO2d`; with `fused_forward` (the default) the rollouts run K4/K5
(`make_fused_apply`), else `FNO2d`'s own forward, cppre's default route.
The keywords are cppre's; the port defaults to the kernels. On the CPU the
kernels take their plain versions. Everything runs on `device`, the card
unless the caller asks for the CPU.

`train_precision` scopes the whole train step, its backward included
(`models.with_train_precision`): "high" and "default" run its float32
matrix products in TF32 on the card (through K4-K7 the kernels stay float32
and the scope reaches only the glue's products); "bf16" autocasts a plain
training apply to bfloat16 activations and refuses `fused_train`, as cppre
does. The calibration and prediction rollouts always run at "highest".

Not ported yet, and refused with NotImplementedError rather than run some
other way: `mesh=` (the parallel layer) and `plots_dir` (plots).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..models import FNO2d, make_fused_apply, make_fused_train_apply, with_train_precision
from ..train.loops import fit
from ..train.losses import lp_loss
from ..train.normalizers import Identity, MinMaxNormalizer
from ..train.rollout import validation_AR
from .pipeline import joint_cp, marginal_cp

__all__ = ["run_2d_cp"]


def _to_convops(field):
    """[BS, Nvar, Nx, Ny, Nt] -> contiguous [BS, Nvar, Nt, Nx, Ny] (the
    reference's permute(0, 1, 4, 2, 3))."""
    return field.permute(0, 1, 4, 2, 3).contiguous()


def run_2d_cp(*, data, residual_fn: Callable, cfg: dict, mode: str = "joint", params=None,
              seed: int = 0, eps: float = 0.0, verbose: bool = True,
              return_residuals: bool = False, mesh=None, fused_forward: bool = True,
              fused_train: bool = True, train_precision: str = "highest", device="cuda"):
    """data [Nsim, Nvar, Nx, Ny, Nt] full trajectories; residual_fn maps
    [BS, Nvar, Nt, Nx, Ny] to a residual. `params` is a state dict of the
    port's `FNO2d` (e.g. from `utils.fno2d_from_jax`), which skips training.
    Returns the JAX package's result keys, with "model" (the trained
    `FNO2d`) in place of "params", and "train_losses" (per-epoch (train,
    test) losses; empty when `params` was given)."""
    if mesh is not None:
        raise NotImplementedError("run_2d_cp(mesh=...) waits for the port's parallel layer")
    if cfg.get("plots_dir"):
        raise NotImplementedError("plots (cfg['plots_dir']) are not ported yet")
    if mode not in ("joint", "marginal"):
        raise ValueError(f"unknown mode {mode!r}")
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    n_train, n_cal, n_pred = cfg.get("n_train", 0), cfg["n_cal"], cfg["n_pred"]
    data = torch.as_tensor(data, dtype=torch.float32, device=device)

    a_all = data[..., :T_in]
    u_all = data[..., T_in:T_in + T_out]
    if cfg.get("Normalisation Strategy", "Min-Max") == "Min-Max":
        in_norm, out_norm = MinMaxNormalizer(a_all), MinMaxNormalizer(u_all)
    else:
        in_norm, out_norm = Identity(device=device), Identity(device=device)
    a_enc, u_enc = in_norm.encode(a_all), out_norm.encode(u_all)

    model = FNO2d(T_in, step, cfg["Modes"], cfg["Modes"], cfg["Variables"], cfg["Width_time"],
                  device=device, generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    train_losses = []
    if params is None:
        if n_train <= 0:
            raise ValueError("params not given and n_train == 0")
        tr_a, tr_u = a_enc[:n_train], u_enc[:n_train]
        if fused_train and train_precision == "bf16":
            raise ValueError("train_precision='bf16' needs the plain training path (the "
                             "kernels K4-K7 are float32); drop fused_train")
        # fused: every forward leg (remat recompute included) runs K4/K5,
        # the backward K6/K7; the precision wraps training only
        train_apply = with_train_precision(
            make_fused_train_apply(model) if fused_train else model, train_precision)
        _, train_losses = fit(train_apply, model, tr_a, tr_u, tr_a[-5:],
                              tr_u[-5:], epochs=cfg["Epochs"], batch_size=cfg["Batch Size"],
                              step=step, T_out=T_out, loss_func=lp_loss,
                              lr=cfg["Learning Rate"], scheduler_step=cfg["Scheduler Step"],
                              scheduler_gamma=cfg["Scheduler Gamma"], seed=seed,
                              verbose=verbose)
    else:
        model.load_state_dict(params)
    train_time = time.perf_counter() - t0
    model.eval()
    apply_fn = make_fused_apply(model) if fused_forward else model

    # Calibration and prediction samples come from the tail of the data and
    # are rolled out in ONE batched call, split after: identical numerics
    # for every scored sample, which CP exchangeability needs.
    cal_sl = slice(n_train, n_train + n_cal)
    pred_sl = slice(n_train + n_cal, n_train + n_cal + n_pred)
    a_cp = torch.cat((a_enc[cal_sl], a_enc[pred_sl]))
    u_cp = torch.cat((u_enc[cal_sl], u_enc[pred_sl]))
    with torch.no_grad():
        pred_all, _, _ = validation_AR(apply_fn, a_cp, u_cp, step, T_out)
        pred_cal, pred_pred = pred_all[:n_cal], pred_all[n_cal:n_cal + n_pred]
        # metrics on the calibration slice only
        mse = torch.mean((pred_cal - u_enc[cal_sl]) ** 2)
        mae = torch.mean(torch.abs(pred_cal - u_enc[cal_sl]))
        if verbose:
            print(f"Calibration rollout MSE {float(mse):.3e} MAE {float(mae):.3e}")
        res_out_cal = residual_fn(_to_convops(out_norm.decode(u_enc[cal_sl])))
        res_pred_cal = residual_fn(_to_convops(out_norm.decode(pred_cal)))
        res_pred = residual_fn(_to_convops(out_norm.decode(pred_pred)))
        res_out_pred = residual_fn(_to_convops(out_norm.decode(u_enc[pred_sl])))

        if mode == "joint":
            aer = joint_cp(res_out_cal, res_pred_cal, res_pred, res_out_pred, eps=eps)
            pre_only = joint_cp(res_out_cal, res_pred_cal, res_pred, mode="pre", eps=eps)
            # the holdout split restores the finite-sample guarantee that the
            # reference's in-sample modulation breaks (pipeline.joint_cp)
            aer_h = joint_cp(res_out_cal, res_pred_cal, res_pred, res_out_pred, eps=eps,
                             holdout_modulation=True)
            pre_h = joint_cp(res_out_cal, res_pred_cal, res_pred, mode="pre", eps=eps,
                             holdout_modulation=True)
        else:
            aer = marginal_cp(res_out_cal, res_pred_cal, res_pred, res_out_pred)
            pre_only = marginal_cp(res_out_cal, res_pred_cal, res_pred, mode="pre")
            aer_h = pre_h = None

    mask = pre_only.get("filter_mask")
    results = {
        "config": cfg, "mode": mode, "model": model, "apply_fn": apply_fn,
        "pred_cal": pred_cal, "pred_pred": pred_pred,
        "train_time": train_time, "train_losses": train_losses,
        "mse": float(mse), "mae": float(mae),
        "alphas": aer["alphas"],
        "coverage_aer_pre": aer["coverage"],
        "coverage_pre": pre_only["coverage"],
        "coverage_aer_pre_holdout": aer_h["coverage"] if aer_h else None,
        "coverage_pre_holdout": pre_h["coverage"] if pre_h else None,
        "qhat": aer["qhat"].detach().cpu().numpy(),
        "filter_mask": mask.cpu().numpy() if mask is not None else None,
        "normalizers": (in_norm, out_norm),
    }
    if return_residuals:
        results.update(res_out_cal=res_out_cal, res_pred_cal=res_pred_cal, res_pred=res_pred,
                       res_out_pred=res_out_pred)
    if verbose:
        for a, c1, c2 in zip(results["alphas"], results["coverage_aer_pre"],
                             results["coverage_pre"]):
            print(f"alpha={a:.2f}  cov(AER+PRE)={c1:.3f}  cov(PRE)={c2:.3f}")
    return results
