"""1-D advection CP experiment: the standalone, data-free pipeline (port
of `cppre.experiments.advection`).

LHS-sampled advection solutions on the device, an FNO1d surrogate trained
on them, one batched autoregressive rollout of the test, calibration and
prediction samples, the composite-kernel PRE (temporal subsampling `disc`
2 in the marginal mode, 1 in the joint), marginal or joint CP with the
alpha sweep, and the residual bounds inverted back to solution space by
deconvolution (`PRE_Advection(...).D.integrate`). No module here has a
Pallas kernel in `cppre`, so on the card it is plain torch, as it is XLA
there.

Run on the card: ``python -m cppre_torch.experiments.advection [marginal|joint]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..cp.inductive import calibrate
from ..models import FNO1d
from ..residuals.advection import PRE_Advection
from ..solvers.advection1d import Advection1D
from ..train.loops import fit
from ..train.losses import mse as mse_loss
from ..train.rollout import autoregressive_rollout
from .common import sample_params
from .pipeline import joint_cp, marginal_cp

__all__ = ["CONFIG", "LB", "UB", "run"]

CONFIG = {
    # reference `Marginal/Advection_Residuals_CP.py:15-38`
    "Case": "Advection", "Field": "u", "Model": "FNO",
    "Epochs": 100, "Batch Size": 10, "Optimizer": "Adam",
    "Learning Rate": 0.001, "Scheduler Step": 100, "Scheduler Gamma": 0.5,
    "Normalisation Strategy": "Identity",
    "T_in": 1, "T_out": 20, "Step": 1, "Width": 16, "Modes": 8,
    "Variables": 1, "Loss Function": "MSE",
    "n_train": 100, "n_test": 100, "n_cal": 100, "n_pred": 100,
    # simulation setup (:85-92)
    "Nx": 200, "Nt": 100, "x_min": 0.0, "x_max": 2.0, "t_end": 0.5, "v": 1.0,
}

LB = np.asarray([0.5, 50.0])   # (pulse centre, sharpness)
UB = np.asarray([1.0, 200.0])


def _gen_fields(sim: Advection1D, params, T_in: int, T_out: int, clock=None):
    """Solver batch -> FNO tensors: crop the ghost cells [1:-2], permute to
    [BS, 1, Nx, Nt]. The speed is CONFIG's, as in `cppre`. `clock`, a
    list, gets the solver's wall seconds appended."""
    t0 = time.perf_counter()
    u = sim.solve_batch(params, CONFIG["v"])[:, :, 1:-2]           # [n, Nt, Nx]
    if clock is not None:
        if u.is_cuda:
            torch.cuda.synchronize(u.device)
        clock.append(time.perf_counter() - t0)
    u = u.permute(0, 2, 1)[:, None].contiguous()                   # [n, 1, Nx, Nt]
    return u[..., :T_in], u[..., T_in:T_in + T_out]


def _to_convops(field):
    """[BS, 1, Nx, Nt] -> [BS, Nt, Nx] (the reference's permute(0,1,3,2)[:,0])."""
    return field.permute(0, 1, 3, 2)[:, 0]


def run(mode: str = "marginal", config: dict | None = None, seed: int = 0,
        verbose: bool = True, device="cuda", return_residuals: bool = False):
    """The experiment on `device`. Returns cppre's result keys, plus
    "model" (the trained `FNO1d`), "train_losses" (per-epoch (train, test)
    losses), "data_time" (the solver's wall seconds) and, with
    `return_residuals`, the calibration and test
    residuals (res_out_cal, res_pred_cal, res_pred_test, res_out_test,
    pred_residual) that the CP sweeps took."""
    if mode not in ("joint", "marginal"):
        raise ValueError(f"unknown mode {mode!r}")
    cfg = dict(CONFIG, **(config or {}))
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    disc = 2 if mode == "marginal" else 1

    sim = Advection1D(cfg["Nx"], cfg["Nt"], cfg["x_min"], cfg["x_max"], cfg["t_end"],
                      device=device)
    pre = PRE_Advection(sim.dt, sim.dx, v=cfg["v"], disc=disc)

    # --- train ---
    clock = []
    t0 = time.perf_counter()
    train_a, train_u = _gen_fields(sim, sample_params(LB, UB, cfg["n_train"], seed), T_in,
                                   T_out, clock)
    model = FNO1d(T_in, step, cfg["Modes"], cfg["Variables"], cfg["Width"], device=device,
                  generator=torch.Generator().manual_seed(seed))
    _, train_losses = fit(model, model, train_a, train_u, train_a[-10:], train_u[-10:],
                          epochs=cfg["Epochs"], batch_size=cfg["Batch Size"], step=step,
                          T_out=T_out, loss_func=mse_loss, lr=cfg["Learning Rate"],
                          scheduler_step=cfg["Scheduler Step"],
                          scheduler_gamma=cfg["Scheduler Gamma"], seed=seed, verbose=verbose)
    if train_a.is_cuda:
        torch.cuda.synchronize(train_a.device)
    train_time = time.perf_counter() - t0
    model.eval()

    # --- test, calibration and prediction rollouts in ONE batched call ---
    test_a, test_u = _gen_fields(sim, sample_params(LB, UB, cfg["n_test"], seed + 1), T_in,
                                 T_out, clock)
    cal_a, cal_u = _gen_fields(sim, sample_params(LB, UB, cfg["n_cal"], seed + 2), T_in, T_out,
                               clock)
    # the prediction set is initial conditions only (no targets)
    pred_a, _ = _gen_fields(sim, sample_params(LB, UB, cfg["n_pred"], seed + 3), T_in, T_out,
                            clock)
    n_test, n_cal = cfg["n_test"], cfg["n_cal"]
    with torch.no_grad():
        pred_all = autoregressive_rollout(model, torch.cat((test_a, cal_a, pred_a)), step, T_out)
        pred_test = pred_all[:n_test]
        pred_cal = pred_all[n_test:n_test + n_cal]
        pred_roll = pred_all[n_test + n_cal:]
        mse = torch.mean((pred_test - test_u) ** 2)
        mae = torch.mean(torch.abs(pred_test - test_u))
        if verbose:
            print(f"Testing Error (MSE): {float(mse):.3e}  (MAE): {float(mae):.3e}")

        res_out_cal = pre(_to_convops(cal_u[..., ::disc]))
        res_pred_cal = pre(_to_convops(pred_cal[..., ::disc]))
        pred_residual = pre(_to_convops(pred_roll[..., ::disc]))
        # the test residuals for the coverage sweep
        res_out_test = pre(_to_convops(test_u[..., ::disc]))
        res_pred_test = pre(_to_convops(pred_test[..., ::disc]))

        cp_fn = marginal_cp if mode == "marginal" else joint_cp
        aer = cp_fn(res_out_cal, res_pred_cal, res_pred_test, res_out_test, mode="aer+pre")
        pre_only = cp_fn(res_out_cal, res_pred_cal, pred_residual, mode="pre")

        # the residual bounds inverted to solution space by deconvolution,
        # a global FFT, so on the UNCROPPED residual
        res_pred_cal_full = pre(_to_convops(pred_cal[..., ::disc]), boundary=True)
        res_out_cal_full = pre(_to_convops(cal_u[..., ::disc]), boundary=True)
        res_pred_test_full = pre(_to_convops(pred_test[..., ::disc]), boundary=True)
        qhat_full = calibrate(torch.abs(res_out_cal_full - res_pred_cal_full), n_cal, 0.1)
        u_lower = pre.D.integrate(res_pred_test_full - qhat_full)
        u_upper = pre.D.integrate(res_pred_test_full + qhat_full)

    mask = pre_only["filter_mask"]
    results = {
        "config": cfg, "mode": mode, "train_time": train_time, "model": model,
        "train_losses": train_losses, "data_time": sum(clock),
        "mse": float(mse), "mae": float(mae),
        "alphas": aer["alphas"],
        "coverage_aer_pre": aer["coverage"],
        "coverage_pre": pre_only["coverage"],
        "qhat": aer["qhat"].detach().cpu().numpy(),
        "n_rejected": int(mask.sum()) if mask is not None else None,
        "inverted_bounds": (u_lower.cpu().numpy(), u_upper.cpu().numpy()),
    }
    if return_residuals:
        results.update(res_out_cal=res_out_cal, res_pred_cal=res_pred_cal,
                       res_pred_test=res_pred_test, res_out_test=res_out_test,
                       pred_residual=pred_residual)
    if verbose:
        for a, c1, c2 in zip(results["alphas"], results["coverage_aer_pre"],
                             results["coverage_pre"]):
            print(f"alpha={a:.2f}  cov(AER+PRE)={c1:.3f}  cov(PRE)={c2:.3f}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "marginal")
