"""2-D Navier-Stokes CP experiment, the flagship (port of `cppre.experiments.ns`).

Spectral NS solutions (u, v, p, w) downsampled `[::t_slice, ::x_slice,
::x_slice]`, a multivariate FNO surrogate trained on them, the momentum (or
continuity) PRE, joint and marginal CP; the marginal mode with
`Variables >= 4` adds CP over the periodic-BC residual of the vorticity.

The momentum residual is the K2 kernel, `ops.kernels.ns_momentum_residual_fused`
(its plain version, equal to `PRE_NS.residual_momentum`, on the CPU); the
continuity residual is `PRE_NS.residual_continuity`.

Run on the card: ``python -m cppre_torch.experiments.ns [joint|marginal]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.kernels import ns_momentum_residual_fused
from ..residuals.ns import PRE_NS
from ..solvers.ns2d_spectral import NavierStokes2D
from .base2d import _to_convops, run_2d_cp
from .common import sample_params

__all__ = ["CONFIG", "LB", "UB", "gen_data", "run"]

CONFIG = {
    # reference `Joint/NS_Residuals_CP.py:13-36`
    "Case": "Navier-Stokes", "Field": "u, v, p", "Model": "FNO",
    "Epochs": 500, "Batch Size": 5, "Optimizer": "Adam",
    "Learning Rate": 0.005, "Scheduler Step": 100, "Scheduler Gamma": 0.5,
    "Normalisation Strategy": "Min-Max",
    "T_in": 1, "T_out": 20, "Step": 1, "Width_time": 16, "Modes": 8,
    "Variables": 3, "Loss Function": "LP",
    "n_train": 100, "n_cal": 100, "n_pred": 100,
    # simulation setup (:77-85, 115-135)
    "N": 400, "tStart": 0.0, "tEnd": 0.5, "dt": 1e-3, "nu": 1e-3, "L": 1.0,
    "t_slice": 10, "x_slice": 4,
    "residual": "momentum",  # or "continuity"
}

LB = np.asarray([0.5, 0.5])  # aa, bb (:200-201)
UB = np.asarray([1.0, 1.0])


def gen_data(cfg: dict, n: int, seed: int = 0, device="cuda"):
    """LHS design -> [n, Nvar, Nx, Ny, Nt] FNO tensor (u, v, p[, w]) on
    `device`, and the grid steps (dt_eff, dx).

    The solver runs in sim-chunks of about 4 GB of stored full-resolution
    trajectories, each sliced `[::x_slice]` before the next solves. The
    design is padded to a chunk multiple (at most chunk-1 throwaway solves)
    so that every solver batch has the same shape."""
    sim = NavierStokes2D(cfg["N"], cfg["tStart"], cfg["tEnd"], cfg["dt"], cfg["nu"], cfg["L"],
                         store_every=cfg["t_slice"], device=device)
    params = sample_params(LB, UB, n, seed)
    xs = cfg["x_slice"]
    n_vars = 4 if cfg.get("Variables", 3) >= 4 else 3
    n_frames = int((cfg["tEnd"] - cfg["tStart"]) / cfg["dt"] / cfg["t_slice"]) + 1
    bytes_per_sim = n_frames * cfg["N"] ** 2 * 4 * 4  # 4 stored fields, f32
    chunk = int(cfg.get("solver_chunk", max(1, int(4e9) // bytes_per_sim)))
    chunk = min(chunk, n)
    n_pad = (-n) % chunk
    params_run = np.concatenate([params, params[:n_pad]]) if n_pad else params
    chunks = []
    for i in range(0, len(params_run), chunk):
        out = sim.solve_batch(params_run[i:i + chunk])
        fields = [f[:, :, ::xs, ::xs] for f in out[:n_vars]]
        chunks.append(torch.stack([torch.movedim(f, 1, -1) for f in fields], dim=1).contiguous())
        del out, fields
    data = torch.cat(chunks, dim=0)[:n]
    dt_eff = cfg["dt"] * cfg["t_slice"]
    dx = cfg["L"] / cfg["N"] * xs
    return data, dt_eff, dx


def run(mode: str = "joint", config: dict | None = None, seed: int = 0, params=None,
        verbose: bool = True, device="cuda", **cp_kwargs):
    """The experiment: data, then `run_2d_cp`. Returns its results, plus
    "data_time" (the solver's wall seconds) and, in marginal mode with
    Variables >= 4, "bc_coverage"."""
    cfg = dict(CONFIG, **(config or {}))
    n_total = cfg["n_train"] + cfg["n_cal"] + cfg["n_pred"]
    t0 = time.perf_counter()
    data, dt_eff, dx = gen_data(cfg, n_total, seed, device)
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    data_time = time.perf_counter() - t0
    pre = PRE_NS(dt_eff, dx, dx, nu=cfg["nu"])
    if cfg["residual"] == "momentum":
        res = lambda f: ns_momentum_residual_fused(f, dt_eff, dx, dx, cfg["nu"])
    else:
        res = getattr(pre, f"residual_{cfg['residual']}")
    out = run_2d_cp(data=data, residual_fn=res, cfg=cfg, mode=mode, params=params, seed=seed,
                    verbose=verbose, device=device, **cp_kwargs)
    out["data_time"] = data_time
    if mode == "marginal" and cfg.get("Variables", 3) >= 4:
        # CP over the periodic-BC violation of the vorticity field
        out["bc_coverage"] = _bc_residual_cp(pre, out, verbose)
    return out


def _bc_residual_cp(pre, out, verbose):
    from .pipeline import marginal_coverage_sweep

    # reuse the rollouts run_2d_cp already computed on the same slices
    _, out_norm = out["normalizers"]
    w_cal = _to_convops(out_norm.decode(out["pred_cal"]))[:, -1]   # vorticity
    w_prd = _to_convops(out_norm.decode(out["pred_pred"]))[:, -1]
    scores = torch.abs(pre.periodic_bc_residual(w_cal))
    bc_pred = pre.periodic_bc_residual(w_prd)
    alphas, cov = marginal_coverage_sweep(scores, bc_pred, None)
    if verbose:
        for a, c in zip(alphas, cov):
            print(f"BC residual: alpha={a:.2f} cov={c:.3f}")
    return cov


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "joint")
