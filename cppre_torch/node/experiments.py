"""NODE experiment drivers: train -> PRE residual -> marginal CP ->
inversion (port of `cppre.node.experiments`).

The reference NODE studies' skeleton for four problems:
  sho | dho      constant-coefficient composite kernels
  bessel         a variable-coefficient residual, non-autonomous NODE
  cauchy_euler   the Bessel pipeline applied to the Cauchy-Euler problem
                 (the reference's own driver is an empty placeholder)

Each mode fits a NODE to one trajectory, rolls out a calibration and a
prediction family over random initial conditions, takes ConvOperator0d
residuals of the position channel, calibrates per-cell (marginal) CP
bounds and checks the inversion round trip integrate(differentiate(x)),
for the variable-coefficient problems through the leading-order operator
D_tt. A family integrates as one batch, each sample with its own steps
(`models.odeint`); `cppre` integrates one sample at a time and takes the
same steps. Plain torch on `device`, the card unless the caller asks for
the CPU: `cppre` has no Pallas kernel here.

Run: ``python -m cppre_torch.node.experiments [sho|dho|bessel|cauchy_euler]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..cp.inductive import calibrate, emp_cov
from ..ops.convops import ConvOperator0d
from .models import ODEFunc, fit_node, neural_odeint
from .problems import (bessel_residual, bessel_state, cauchy_euler_residual, cauchy_euler_state,
                       dho_residual_kernel, dho_solution, sho_residual_kernel, sho_solution)

__all__ = ["run", "PROBLEMS"]

PROBLEMS = ("sho", "dho", "bessel", "cauchy_euler")

# Cauchy-Euler coefficients of the driver: a = b = 1 gives the bounded
# oscillatory branch y = c1 cos(ln t) + c2 sin(ln t) on t > 0
_CE_A, _CE_B = 1.0, 1.0


def _trajectories(problem: str, n: int, t, seed: int = 0):
    """A family over random initial conditions or coefficients ->
    [n, Nt, 2] float32 numpy, from `np.random.RandomState(seed)`:
    sho/dho [x0, v0] uniform; bessel the amplitude ~ U(0.5, 1.5) on A*J_0;
    cauchy_euler (c1, c2) uniform on the oscillatory closed form."""
    rng = np.random.RandomState(seed)
    if problem in ("sho", "dho"):
        x0s = rng.uniform(0.5, 1.5, n)
        v0s = rng.uniform(-0.5, 0.5, n)
        sol = sho_solution if problem == "sho" else dho_solution
        xs = np.stack([sol(t, x0, v0) for x0, v0 in zip(x0s, v0s)])
        vs = np.gradient(xs, t, axis=1)
        return np.stack([xs, vs], axis=-1).astype(np.float32)
    if problem == "bessel":
        amps = rng.uniform(0.5, 1.5, n)
        return np.stack([bessel_state(t, amp) for amp in amps])
    if problem == "cauchy_euler":
        c1s = rng.uniform(0.5, 1.5, n)
        c2s = rng.uniform(-0.5, 0.5, n)
        return np.stack([cauchy_euler_state(t, c1, c2, _CE_A, _CE_B)
                         for c1, c2 in zip(c1s, c2s)])
    raise ValueError(f"unknown problem {problem!r} (one of {PROBLEMS})")


def _domain(problem: str, Nt: int, t_end: float | None):
    """The time grid: the variable-coefficient problems start away from
    their t = 0 singularity."""
    if problem in ("sho", "dho"):
        return np.linspace(0.0, 10.0 if t_end is None else t_end, Nt).astype(np.float32)
    if problem == "bessel":
        return np.linspace(0.5, 12.0 if t_end is None else t_end, Nt).astype(np.float32)
    return np.linspace(1.0, 8.0 if t_end is None else t_end, Nt).astype(np.float32)


def _residuals(problem: str, t, fields):
    """Per-cell PRE of the position channel [n, Nt] -> ([n, L_interior],
    the operator the round trip inverts)."""
    dt = float(t[1] - t[0])
    if problem in ("sho", "dho"):
        D = sho_residual_kernel(dt) if problem == "sho" else dho_residual_kernel(dt)
        return D(fields)[..., 2:-2], D
    if problem == "bessel":
        res = bessel_residual(fields, t)
    else:
        res = cauchy_euler_residual(fields, t, _CE_A, _CE_B)
    # the leading-order operator for the inversion round trip
    return res[..., 3:-3], ConvOperator0d(order=2)


def run(problem: str = "sho", n_train: int = 4, n_cal: int = 32, n_pred: int = 16,
        Nt: int = 100, t_end: float | None = None, epochs: int = 300, alpha: float = 0.1,
        seed: int = 0, verbose: bool = True, device="cuda"):
    """The study of `problem` on `device`. Returns `cppre`'s result keys
    (problem, mse, coverage, alpha, qhat, roundtrip_err), plus "model" (the
    trained `ODEFunc`), "fit_losses", "fit_s" (the fit's wall seconds) and
    "steps": the accepted and rejected steps of the calibration and
    prediction rollouts, summed."""
    if problem not in PROBLEMS:
        raise ValueError(f"unknown problem {problem!r} (one of {PROBLEMS})")
    t = _domain(problem, Nt, t_end)
    time_dependent = problem in ("bessel", "cauchy_euler")

    train = _trajectories(problem, n_train, t, seed)
    model = ODEFunc(hidden_dim=50, state_dim=2, time_dependent=time_dependent, device=device)
    # fit on the first trajectory (the reference trains single-IC NODEs)
    t0 = time.perf_counter()
    _, fit_losses = fit_node(model, train[0, 0], t, train[0], epochs=epochs, seed=seed,
                             verbose=verbose)
    fit_s = time.perf_counter() - t0

    cal = _trajectories(problem, n_cal, t, seed + 1)
    pred = _trajectories(problem, n_pred, t, seed + 2)
    with torch.no_grad():
        cal_pred, cal_stats = neural_odeint(model, cal[:, 0], t, return_stats=True)
        pred_pred, pred_stats = neural_odeint(model, pred[:, 0], t, return_stats=True)

        res_cal, D = _residuals(problem, t, cal_pred[..., 0])
        res_pred, _ = _residuals(problem, t, pred_pred[..., 0])
        qhat = calibrate(torch.abs(res_cal), n_cal, alpha)
        coverage = emp_cov((-qhat, qhat), res_pred)

        # inversion round trip: integrate(differentiate(x)) ~ x away from
        # the edges (it trims k//2 cells a side; align on the shared interior)
        x = torch.as_tensor(cal[:1, :, 0]).to(cal_pred.device)
        recovered = D.integrate(D.differentiate(x))
        L = recovered.shape[-1] - 6
        roundtrip_err = float(torch.abs(recovered[0, 3:3 + L] - x[0, 3:3 + L]).max())
        truth = torch.as_tensor(pred[..., 0]).to(pred_pred.device)
        mse = float(torch.mean((pred_pred[..., 0] - truth) ** 2))

    results = {
        "problem": problem, "mse": mse, "coverage": float(coverage), "alpha": alpha,
        "qhat": qhat.cpu().numpy(), "roundtrip_err": roundtrip_err,
        "model": model, "fit_losses": fit_losses, "fit_s": fit_s,
        "steps": {k: int(cal_stats[k].sum() + pred_stats[k].sum())
                  for k in ("accepted", "rejected")},
    }
    if verbose:
        print(f"{problem}: NODE MSE {results['mse']:.3e}, "
              f"coverage {coverage:.3f} (1-alpha = {1-alpha}), "
              f"inversion roundtrip err {roundtrip_err:.3e}")
    return results


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "sho")
