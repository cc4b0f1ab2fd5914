"""Offline single-shot CP pipeline, the `Expts_initial` workflow (port of
`cppre.experiments.initial`).

`run_offline` is the "bring your own dataset and weights" entry point:
calibration and prediction data come from a saved dataset, the surrogate
from a saved checkpoint; the residual is calibrated marginally, and the
residual bounds are inverted back to solution space by deconvolution:

    run_offline(data="wave.npz", ckpt="FNO_Wave_run1",
                residual_fn=PRE_Wave(dt, dx), cfg={...},
                invert_with=PRE_Wave(dt, dx).D)

Dataset schema: an npz with `fields` [Nsim, Nvar, Nx, Ny, Nt], or the
array itself. The surrogate is the port's `FNO2d`, loaded from a port
checkpoint (`utils.save_checkpoint`) or a state dict in `params`; its
rollout takes `models.make_fused_apply`, so on the card it runs kernels K4
and K5 (a shape the kernels do not take raises there).

`run_initial(case)` runs one of the historical per-family pipelines at its
configuration (`INITIAL_CONFIGS`) through the family's `run` in marginal
mode.
"""

from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch

from ..cp import calibrate, emp_cov
from ..models import FNO2d, make_fused_apply
from ..train.normalizers import Identity
from ..train.rollout import validation_AR
from ..utils.checkpoint import load_checkpoint, load_norms

__all__ = ["run_offline", "run_initial", "INITIAL_CONFIGS"]


def run_offline(*, data, residual_fn, cfg: dict, ckpt: str | None = None, params=None,
                norms: str | None = None, invert_with=None, alphas=None, verbose: bool = True,
                device="cuda"):
    """Offline marginal CP + residual-bound inversion, on `device`.

    data: array [Nsim, Nvar, Nx, Ny, Nt] or a path to an npz with `fields`.
    ckpt/params: the pretrained surrogate (a port checkpoint path, or a
    state dict of the port's `FNO2d`); norms: an optional
    `<...>_norms.npz` path. invert_with: an operator whose `.integrate`
    inverts the residual (e.g. `PRE_Wave(...).D`); None skips the
    inversion."""
    if isinstance(data, str):
        data = np.load(data)["fields"]
    data = torch.as_tensor(data, dtype=torch.float32, device=device)
    T_in, T_out, step = cfg["T_in"], cfg["T_out"], cfg["Step"]
    n_cal = cfg["n_cal"]

    a_all = data[..., :T_in]
    u_all = data[..., T_in:T_in + T_out]
    if norms is not None:
        in_norm, out_norm = load_norms(norms, device)
    else:
        in_norm, out_norm = Identity(device=device), Identity(device=device)

    model = FNO2d(T_in, step, cfg["Modes"], cfg["Modes"], cfg["Variables"], cfg["Width_time"],
                  device=device)
    if params is None:
        if ckpt is None:
            raise ValueError("run_offline needs a pretrained surrogate: "
                             "pass `ckpt` (checkpoint path) or `params`")
        load_checkpoint(ckpt, model)
    else:
        model.load_state_dict(params)
    model.eval()
    apply_fn = make_fused_apply(model)

    with torch.no_grad():
        pred_enc, _, _ = validation_AR(apply_fn, in_norm.encode(a_all),
                                       out_norm.encode(u_all), step, T_out)
    pred = out_norm.decode(pred_enc)

    def to_ops(f):
        return torch.movedim(f, -1, 1)[:, :, 0] if f.shape[1] == 1 else torch.movedim(f, -1, 2)

    res_out = residual_fn(to_ops(u_all))
    res_pred = residual_fn(to_ops(pred))

    cal, prd = slice(0, n_cal), slice(n_cal, None)
    # metrics in decoded space, on the calibration slice only
    mse = torch.mean((pred[cal] - u_all[cal]) ** 2)
    mae = torch.mean(torch.abs(pred[cal] - u_all[cal]))
    scores = torch.abs(res_out[cal] - res_pred[cal])
    if alphas is None:
        alphas = np.arange(0.05, 0.95 + 1e-9, 0.1)
    coverage = []
    for a in alphas:
        q = calibrate(scores, n_cal, float(a))
        sets = [res_pred[prd] - q, res_pred[prd] + q]
        coverage.append(float(emp_cov(sets, res_out[prd])))

    out = {"mse": float(mse), "mae": float(mae),
           "alphas": np.asarray(alphas), "coverage": np.asarray(coverage)}

    if invert_with is not None:
        # the alpha = 0.1 bounds inverted to solution space; the
        # deconvolution is a global FFT, so on the UNCROPPED residual
        try:
            has_boundary = "boundary" in inspect.signature(residual_fn).parameters
        except (TypeError, ValueError):
            has_boundary = False
        if not has_boundary:
            warnings.warn(
                "residual_fn has no `boundary` parameter: the inversion stage will "
                "deconvolve the residual on its own (possibly interior-cropped) grid, not "
                "the operator's uncropped grid; inverted bounds may differ from the "
                "Expts_initial contract near the boundary", stacklevel=2)
        res_pred_full = (residual_fn(to_ops(pred), boundary=True) if has_boundary
                         else residual_fn(to_ops(pred)))
        qf = calibrate(scores, n_cal, 0.1)
        if qf.shape != res_pred_full.shape[1:]:
            # embed the cropped qhat in the full grid (a zero halo as wide as
            # the crop on each axis)
            full = res_pred_full.shape[1:]
            sl = tuple(slice((f - c) // 2, (f - c) // 2 + c) for f, c in zip(full, qf.shape))
            q_full = qf.new_zeros(full)
            q_full[sl] = qf
            qf = q_full
        out["inverted_bounds"] = (
            invert_with.integrate(res_pred_full[prd] - qf).cpu().numpy(),
            invert_with.integrate(res_pred_full[prd] + qf).cpu().numpy())

    if verbose:
        for a, c in zip(out["alphas"], out["coverage"]):
            print(f"alpha={a:.2f}  coverage={c:.3f}")
    return out


# The historical per-family pipelines (the reference's `Expts_initial`
# scripts): the single-shot skeleton of the family `run`s at an earlier
# configuration (longer T_in windows, chunked steps).
INITIAL_CONFIGS = {
    # Expts_initial/Advection_Residuals_CP.py:13-37 (1-D, single-shot 30)
    "Advection": {"T_in": 20, "T_out": 30, "Step": 30, "Width": 32,
                  "Modes": 8, "Variables": 1, "Batch Size": 50,
                  "n_cal": 100, "n_pred": 100},
    # Expts_initial/Burgers_Residuals_CP.py:13-37 (1-D, single-shot 30)
    "Burgers": {"T_in": 20, "T_out": 30, "Step": 30, "Width": 32,
                "Modes": 8, "Variables": 1, "Batch Size": 50,
                "n_cal": 100, "n_pred": 100},
    # Expts_initial/Wave_Residuals_CP.py:13-37 (2-D, chunked step 10)
    "Wave": {"T_in": 20, "T_out": 60, "Step": 10, "Width_time": 32,
             "Modes": 8, "Variables": 1, "Batch Size": 50,
             "n_cal": 100, "n_pred": 100},
    # Expts_initial/NS_Residuals_CP.py:12-36 (4 fields, chunked step 10)
    "Navier-Stokes": {"T_in": 10, "T_out": 40, "Step": 10, "Width_time": 16,
                      "Modes": 8, "Variables": 4, "Batch Size": 50,
                      "n_cal": 100, "n_pred": 100},
    # Expts_initial/MHD_Residuals_CP.py:12-36 (6 fields, chunked step 5)
    "MHD": {"T_in": 10, "T_out": 20, "Step": 5, "Width_time": 16,
            "Modes": 8, "Variables": 6, "Batch Size": 20,
            "n_cal": 100, "n_pred": 100},
    # Expts_initial/JOREK_residuals_CP.py:12-36 (3 fields, chunked step 5)
    "JOREK": {"T_in": 10, "T_out": 40, "Step": 5, "Width_time": 32,
              "Modes": 16, "Variables": 3, "Batch Size": 10,
              "n_cal": 100, "n_pred": 100},
}


def run_initial(case: str, config: dict | None = None, **kw):
    """One historical `Expts_initial` pipeline, by family: the family's
    `run` in marginal mode (the initial scripts' CP is marginal) at the
    script's configuration, overridable by `config`. Other keywords pass
    through to that `run` (verbose=, device=, data_path= for JOREK, ...).

    The Burgers entry's window (T_in 20 + T_out 30) is longer than the
    Burgers solver's Nt 21, so `burgers.run` refuses it unless `config`
    raises Nt."""
    from . import advection, burgers, jorek, mhd, ns, wave

    runs = {"Advection": advection.run, "Burgers": burgers.run,
            "Wave": wave.run, "Navier-Stokes": ns.run, "MHD": mhd.run,
            "JOREK": jorek.run}
    if case not in runs:
        raise ValueError(f"unknown Expts_initial case {case!r}; one of {sorted(runs)}")
    cfg = dict(INITIAL_CONFIGS[case], **(config or {}))
    return runs[case]("marginal", config=cfg, **kw)
