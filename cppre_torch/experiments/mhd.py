"""2-D ideal MHD CP experiment (port of `cppre.experiments.mhd`).

Constrained-transport MHD solutions over 6 fields (rho, u, v, p, Bx, By),
a multivariate FNO surrogate, five selectable residual equations, joint CP
with the +1e-6 modulation guard. The residual is kernel K2's MHD instance,
`ops.kernels.mhd_residual_fused` (its plain version, equal to `PRE_MHD`, on
the CPU).

Run on the card: ``python -m cppre_torch.experiments.mhd [joint|marginal] [equation]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.kernels import mhd_residual_fused
from ..solvers.mhd2d_constrained import _mhd_run, _params
from .base2d import run_2d_cp
from .common import sample_params

__all__ = ["CONFIG", "LB", "UB", "gen_data", "run"]

CONFIG = {
    # reference `Joint/MHD_Residuals_CP.py:14-36`
    "Case": "MHD", "Field": "rho, u, v, p, Bx, By", "Model": "FNO",
    "Epochs": 500, "Batch Size": 5, "Optimizer": "Adam",
    "Learning Rate": 0.005, "Scheduler Step": 100, "Scheduler Gamma": 0.5,
    "Normalisation Strategy": "Min-Max",
    "T_in": 1, "T_out": 20, "Step": 1, "Width_time": 16, "Modes": 8,
    "Variables": 6, "Loss Function": "LP",
    "n_train": 100, "n_cal": 100, "n_pred": 100,
    # simulation setup (:76-82, 127-140)
    "N": 128, "boxsize": 1.0, "tEnd": 0.5, "dt": 1e-4, "t_slice": 25,
    "equation": "induction",  # reference's default switch (:323)
}

LB = np.asarray([0.5, 0.5, 0.5])  # a, b, c (:206-207)
UB = np.asarray([1.0, 1.0, 1.0])


def gen_data(cfg: dict, n: int, seed: int = 0, lb=None, ub=None, device="cuda"):
    """LHS design -> [n, 6, Nx, Ny, Nt] FNO tensor on `device`, and the grid
    steps (dt_eff, dx).

    `lb`/`ub` override the (a, b, c) design box (default: the reference's
    training box LB..UB). Every stored frame is kept, as the JAX package
    returns them: at the flagship that is [300, 6, 128, 128, 201] float32,
    23.7 GB, of which `run_2d_cp` uses the first T_in + T_out frames. The
    solver writes the frames straight into that tensor, all designs
    stepping together."""
    params = sample_params(LB if lb is None else np.asarray(lb),
                           UB if ub is None else np.asarray(ub), n, seed)
    data, _ = _mhd_run(_params(params, device), cfg["N"], int(round(cfg["tEnd"] / cfg["dt"])),
                       cfg["t_slice"], cfg["boxsize"] / cfg["N"], cfg["dt"])
    return data, cfg["dt"] * cfg["t_slice"], cfg["boxsize"] / cfg["N"]


def run(mode: str = "joint", config: dict | None = None, seed: int = 0, params=None,
        verbose: bool = True, device="cuda", **cp_kwargs):
    """The experiment: data, then `run_2d_cp`. Returns its results, plus
    "data_time" (the solver's wall seconds)."""
    cfg = dict(CONFIG, **(config or {}))
    n_total = cfg["n_train"] + cfg["n_cal"] + cfg["n_pred"]
    t0 = time.perf_counter()
    data, _, _ = gen_data(cfg, n_total, seed, device=device)
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    data_time = time.perf_counter() - t0
    res = lambda fields: mhd_residual_fused(fields, equation=cfg["equation"])
    cp_kwargs.setdefault("eps", 1e-6)  # reference's modulation guard (:350)
    out = run_2d_cp(data=data, residual_fn=res, cfg=cfg, mode=mode, params=params, seed=seed,
                    verbose=verbose, device=device, **cp_kwargs)
    out["data_time"] = data_time
    return out


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = sys.argv[1] if len(sys.argv) > 1 else "joint"
    run(mode, config={"equation": sys.argv[2]} if len(sys.argv) > 2 else None)
