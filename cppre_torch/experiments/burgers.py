"""1-D Burgers CP experiment (port of `cppre.experiments.burgers`).

Spectral Burgers solutions on the device, an FNO1d surrogate trained on
them (relative L2 loss), one batched rollout of the calibration and
prediction samples, the multi-kernel PRE (the nonlinear u u_x term has no
single composite kernel), joint or marginal CP with the alpha sweep, and
in joint mode the holdout-modulation estimator. Plain torch on the card:
`cppre` has no Pallas kernel on this path either.

One deviation: `run` raises ValueError before solving when
T_in + T_out > Nt (the data has no such window), where `cppre` fails with
a TypeError in training.

Run on the card: ``python -m cppre_torch.experiments.burgers [joint|marginal]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import FNO1d, with_train_precision
from ..residuals.burgers import PRE_Burgers
from ..solvers.burgers1d import Burgers1D
from ..train.loops import fit
from ..train.losses import lp_loss
from ..train.rollout import validation_AR
from .common import sample_params
from .pipeline import joint_cp, marginal_cp

__all__ = ["CONFIG", "LB", "UB", "run"]

CONFIG = {
    "Case": "Burgers", "Field": "u", "Model": "FNO",
    "Epochs": 100, "Batch Size": 10, "Optimizer": "Adam",
    "Learning Rate": 0.005, "Scheduler Step": 100, "Scheduler Gamma": 0.5,
    "Normalisation Strategy": "Identity",
    "T_in": 1, "T_out": 20, "Step": 1, "Width": 16, "Modes": 8,
    "Variables": 1, "Loss Function": "LP",
    "n_train": 100, "n_cal": 100, "n_pred": 100,
    # solver setup (`Active_Learning/Burgers_AL_Joint.py:83-96`)
    "Nx": 200, "Nt": 21, "x_min": 0.0, "x_max": 2.0, "t_end": 0.5, "nu": 0.002,
}

LB = np.asarray([-3.0, -3.0, -3.0])  # the IC's sine-mode coefficients
UB = np.asarray([3.0, 3.0, 3.0])


def _to_convops(field):
    """[BS, 1, Nx, Nt] -> [BS, Nt, Nx]."""
    return field.permute(0, 1, 3, 2)[:, 0]


def run(mode: str = "joint", config: dict | None = None, seed: int = 0,
        verbose: bool = True, train_precision: str = "highest", device="cuda",
        return_residuals: bool = False):
    """The experiment on `device`. Returns cppre's result keys, plus
    "model" (the trained `FNO1d`), "train_losses", "data_time" (the
    solver's wall seconds) and, with
    `return_residuals`, the residuals the CP sweeps took (res_out_cal,
    res_pred_cal, res_pred, res_out_pred)."""
    if mode not in ("joint", "marginal"):
        raise ValueError(f"unknown mode {mode!r}")
    cfg = dict(CONFIG, **(config or {}))
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    if T_in + T_out > cfg["Nt"]:
        raise ValueError(f"T_in + T_out = {T_in} + {T_out} = {T_in + T_out} frames, but the "
                         f"solver stores Nt = {cfg['Nt']}: raise config['Nt'] or shorten "
                         "the window")
    sim = Burgers1D(cfg["Nx"], cfg["Nt"], cfg["x_min"], cfg["x_max"], cfg["t_end"], cfg["nu"],
                    device=device)
    pre = PRE_Burgers(sim.dt, sim.dx, nu=cfg["nu"])

    n_total = cfg["n_train"] + cfg["n_cal"] + cfg["n_pred"]
    t0 = time.perf_counter()
    u = sim.solve_batch(sample_params(LB, UB, n_total, seed))          # [n, Nt, Nx]
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    data_time = time.perf_counter() - t0
    data = u.permute(0, 2, 1)[:, None].contiguous()                    # [n, 1, Nx, Nt]
    a_all, u_all = data[..., :T_in], data[..., T_in:T_in + T_out]

    tr = slice(0, cfg["n_train"])
    cal = slice(cfg["n_train"], cfg["n_train"] + cfg["n_cal"])
    prd = slice(cfg["n_train"] + cfg["n_cal"], n_total)

    model = FNO1d(T_in, step, cfg["Modes"], cfg["Variables"], cfg["Width"], device=device,
                  generator=torch.Generator().manual_seed(seed))
    # the precision wraps training only; the CP rollouts stay at "highest"
    train_apply = with_train_precision(model, train_precision)
    t0 = time.perf_counter()
    _, train_losses = fit(train_apply, model, a_all[tr], u_all[tr], a_all[tr][-5:], u_all[tr][-5:],
                          epochs=cfg["Epochs"], batch_size=cfg["Batch Size"], step=step,
                          T_out=T_out, loss_func=lp_loss, lr=cfg["Learning Rate"],
                          scheduler_step=cfg["Scheduler Step"],
                          scheduler_gamma=cfg["Scheduler Gamma"], seed=seed, verbose=verbose)
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    train_time = time.perf_counter() - t0
    model.eval()

    with torch.no_grad():
        # calibration and prediction rollouts in ONE batched call
        pred_both, _, _ = validation_AR(model, torch.cat((a_all[cal], a_all[prd])),
                                        torch.cat((u_all[cal], u_all[prd])), step, T_out)
        pred_cal, pred_prd = pred_both[:cfg["n_cal"]], pred_both[cfg["n_cal"]:]
        # metrics on the calibration slice only
        mse = torch.mean((pred_cal - u_all[cal]) ** 2)
        mae = torch.mean(torch.abs(pred_cal - u_all[cal]))
        res_out_cal = pre(_to_convops(u_all[cal]))
        res_pred_cal = pre(_to_convops(pred_cal))
        res_pred = pre(_to_convops(pred_prd))
        res_out_pred = pre(_to_convops(u_all[prd]))

        cp_fn = joint_cp if mode == "joint" else marginal_cp
        aer = cp_fn(res_out_cal, res_pred_cal, res_pred, res_out_pred)
        pre_only = cp_fn(res_out_cal, res_pred_cal, res_pred, mode="pre")
        aer_h = joint_cp(res_out_cal, res_pred_cal, res_pred, res_out_pred,
                         holdout_modulation=True) if mode == "joint" else None

    results = {
        "config": cfg, "mode": mode, "mse": float(mse), "mae": float(mae),
        "train_time": train_time, "model": model, "train_losses": train_losses,
        "data_time": data_time,
        "alphas": aer["alphas"], "coverage_aer_pre": aer["coverage"],
        "coverage_pre": pre_only["coverage"], "qhat": aer["qhat"].detach().cpu().numpy(),
        "coverage_aer_pre_holdout": aer_h["coverage"] if aer_h else None,
    }
    if return_residuals:
        results.update(res_out_cal=res_out_cal, res_pred_cal=res_pred_cal, res_pred=res_pred,
                       res_out_pred=res_out_pred)
    if verbose:
        for a, c1, c2 in zip(results["alphas"], results["coverage_aer_pre"],
                             results["coverage_pre"]):
            print(f"alpha={a:.2f}  cov(AER+PRE)={c1:.3f}  cov(PRE)={c2:.3f}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "joint")
