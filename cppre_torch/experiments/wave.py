"""2-D wave-equation CP experiment (port of `cppre.experiments.wave`).

Spectral wave solutions on a 64^2 grid, a MinMax-normalised FNO surrogate
(width 32, modes 16, one variable) trained on them, the composite-kernel
PRE `D_tt - (c dt/dx)^2 D_xxyy`, joint (modulated sup-norm) and marginal CP.
The residual is kernel K8, `ops.kernels.wave_residual_fused` (its plain
version, equal to `PRE_Wave`, on the CPU).

Run on the card: ``python -m cppre_torch.experiments.wave [joint|marginal]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.kernels import wave_residual_fused
from ..residuals.wave import PRE_Wave
from ..solvers.wave2d_spectral import Wave2D
from .base2d import _to_convops, run_2d_cp
from .common import sample_params

__all__ = ["CONFIG", "LB", "UB", "gen_data", "run", "discretisation_sweep"]

CONFIG = {
    # reference `Joint/Wave_Residuals_CP.py:12-37` (n_* shrunk-able via config)
    "Case": "Wave", "Field": "u", "Model": "FNO",
    "Epochs": 500, "Batch Size": 50, "Optimizer": "Adam",
    "Learning Rate": 0.005, "Scheduler Step": 100, "Scheduler Gamma": 0.5,
    "Normalisation Strategy": "Min-Max",
    "T_in": 1, "T_out": 20, "Step": 1, "Width_time": 32, "Modes": 16,
    "Variables": 1, "Loss Function": "LP",
    "n_train": 800, "n_test": 200, "n_cal": 1000, "n_pred": 100,
    # simulation setup (:76-90)
    "Nx": 64, "x_min": -1.0, "x_max": 1.0, "tend": 1.0, "c": 1.0, "t_slice": 5,
}

LB = np.asarray([10.0, 0.10, 0.10])  # amplitude, x_pos, y_pos (AL bounds)
UB = np.asarray([50.0, 0.50, 0.50])


def _sim(cfg, device):
    return Wave2D(cfg["Nx"], cfg["x_min"], cfg["x_max"], cfg["tend"], cfg["c"], device=device)


def gen_data(cfg: dict, n: int, seed: int = 0, device="cuda"):
    """LHS design -> [n, 1, Nx, Ny, Nt_sliced] FNO tensor on `device`, and
    the grid steps (dt_eff, dx)."""
    sim = _sim(cfg, device)
    u = sim.solve_batch(sample_params(LB, UB, n, seed))[:, :: cfg["t_slice"]]
    data = torch.movedim(u, 1, -1)[:, None].contiguous()  # [n, 1, Nx, Ny, Nt]
    return data, sim.dt * cfg["t_slice"], sim.dx


def run(mode: str = "joint", config: dict | None = None, seed: int = 0, params=None,
        verbose: bool = True, device="cuda", **cp_kwargs):
    """The experiment: data, then `run_2d_cp`. Returns its results, plus
    "data_time" (the solver's wall seconds)."""
    cfg = dict(CONFIG, **(config or {}))
    n_total = cfg["n_train"] + cfg["n_cal"] + cfg["n_pred"]
    t0 = time.perf_counter()
    data, dt_eff, dx = gen_data(cfg, n_total, seed, device)
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    data_time = time.perf_counter() - t0
    pre = PRE_Wave(dt_eff, dx, c=cfg["c"])
    residual_fn = lambda fields: wave_residual_fused(fields[:, 0], pre.D.kernel)
    out = run_2d_cp(data=data, residual_fn=residual_fn, cfg=cfg, mode=mode, params=params,
                    seed=seed, verbose=verbose, device=device, **cp_kwargs)
    out["data_time"] = data_time
    return out


def discretisation_sweep(data, params, discs=(1, 2, 4), config: dict | None = None,
                         seed: int = 0, verbose: bool = True, device="cuda"):
    """Coverage at coarser temporal discretisations (the marginal
    experiment's rebuttal study, reference `Marginal/Wave_Residuals_CP.py:
    458-480`): re-form the composite kernel with dt*disc, subsample the
    rollout and targets `[..., ::disc]`, and sweep marginal coverage per
    disc. `params` is a state dict of the port's `FNO2d`."""
    from ..models import FNO2d, make_fused_apply
    from ..train.normalizers import MinMaxNormalizer
    from ..train.rollout import validation_AR
    from .pipeline import marginal_cp

    cfg = dict(CONFIG, **(config or {}))
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    sim = _sim(cfg, device)
    dt_eff, dx = sim.dt * cfg["t_slice"], sim.dx

    data = torch.as_tensor(data, dtype=torch.float32, device=device)
    a_all, u_all = data[..., :T_in], data[..., T_in:T_in + T_out]
    in_n, out_n = MinMaxNormalizer(a_all), MinMaxNormalizer(u_all)
    model = FNO2d(T_in, step, cfg["Modes"], cfg["Modes"], cfg["Variables"], cfg["Width_time"],
                  device=device)
    model.load_state_dict(params)
    model.eval()
    n_cal = data.shape[0] // 2
    with torch.no_grad():
        pred, _, _ = validation_AR(make_fused_apply(model), in_n.encode(a_all),
                                   out_n.encode(u_all), step, T_out)
        pred = out_n.decode(pred)
        results = {}
        for disc in discs:
            pre = PRE_Wave(dt_eff * disc, dx, c=cfg["c"])
            ro = pre(_to_convops(u_all[..., ::disc])[:, 0])
            rp = pre(_to_convops(pred[..., ::disc])[:, 0])
            out = marginal_cp(ro[:n_cal], rp[:n_cal], rp[n_cal:], ro[n_cal:])
            results[disc] = out["coverage"]
            if verbose:
                print(f"disc={disc}: coverage {np.round(np.asarray(out['coverage']), 3)}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "joint")
