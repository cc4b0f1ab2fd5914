"""Grad-Shafranov CP experiments: the FreeGSNKE and EFIT pipelines (port of
`cppre.experiments.gs`).

* `run_freegsnke` trains a conditional surrogate psi = model(coords,
  params), the `ConvAutoencoder` or (config "Model": "INR") the `INR`, on
  the analytic Solov'ev family, then runs marginal CP and joint CP with
  modulation over the GS-operator residual.
* `run_efit` runs marginal CP over (psi_true, psi_pred) pairs: given
  arrays (e.g. from `load_efit_csv`), or a synthetic Solov'ev ensemble with
  perturbed predictions.

Neither has a kernel: the surrogates, the residual and CP are plain torch
on `device` (the card unless the caller asks for the CPU), as they are XLA
in `cppre`. Training is `torch.optim.Adam` with optax's defaults (b1 0.9,
b2 0.999, eps 1e-8, bias-corrected) on the mean squared error, over
minibatches of a permutation drawn each epoch from a `torch.Generator`
seeded with `seed` (cppre draws it from `jax.random`, so the two packages
visit the samples in different orders). On the card a train step is one
CUDA graph; the loop makes no host sync unless `verbose` prints.

Run on the card: ``python -m cppre_torch.experiments.gs [freegsnke|efit]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.cae import ConvAutoencoder
from ..models.inr import INR
from ..residuals.gs import PRE_GradShafranov
from ..solvers.solovev import solovev_batch
from ..train.normalizers import MinMaxNormalizer
from .pipeline import joint_cp, marginal_cp

__all__ = ["CONFIG", "load_efit_csv", "run_efit", "run_freegsnke"]

CONFIG = {
    # reference `FreeGSNKE/GS_CP.py:33-52`-style schema
    "Case": "Grad-Shafranov", "Model": "CAE",
    "Epochs": 200, "Batch Size": 32, "Learning Rate": 1e-3,
    "Normalisation Strategy": "Min-Max",
    "NR": 64, "NZ": 64, "n_total": 512, "n_train": 300,
}


def _make_surrogate(cfg: dict, n_params: int, seed: int = 0, device="cuda"):
    """The configured surrogate ("Model": "CAE" or "INR") at `cppre`'s
    defaults, its weights drawn from `seed`."""
    g = torch.Generator().manual_seed(seed)
    if cfg.get("Model", "CAE").upper() == "INR":
        return INR(n_params=n_params, device=device, generator=g)
    return ConvAutoencoder(n_params=n_params, grid=(cfg["NR"], cfg["NZ"]), device=device,
                           generator=g)


def _adam(model, cfg, capturable=False):
    """optax.adam(cfg["Learning Rate"]) as torch's Adam: b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias-corrected; fused, one kernel for
    every parameter; `capturable` (its step count on the card) for a CUDA
    graph."""
    return torch.optim.Adam(model.parameters(), lr=cfg["Learning Rate"], betas=(0.9, 0.999),
                            eps=1e-8, fused=True, capturable=capturable)


def _mse(model, coords, params_in, psi):
    return torch.mean((model(coords, params_in) - psi) ** 2)


def _surrogate_step(model, coords, params_in, psi, cfg):
    """(idx, step): `step()` takes one Adam step on the MSE of the rows
    `idx` holds (a device tensor of the batch size, which the caller
    fills) and returns its loss. On the card the first call runs eagerly on
    a side stream (it builds the optimizer's state and the libraries'
    workspaces); the second captures the gather, forward, backward and Adam
    step as one CUDA graph, and every call replays it: one launch a step
    and no host sync, where the eager step is bound by its ~100 launches."""
    dev = coords.device
    idx = torch.zeros(min(cfg["Batch Size"], params_in.shape[0]), dtype=torch.long, device=dev)
    opt = _adam(model, cfg, capturable=coords.is_cuda)
    graph, out, calls = None, None, 0

    def forward_backward():
        loss = _mse(model, coords[idx], params_in[idx], psi[idx])
        loss.backward()
        opt.step()
        return loss

    def step():
        nonlocal graph, out, calls
        calls += 1
        if graph is None and coords.is_cuda and calls == 1:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                opt.zero_grad(set_to_none=True)
                loss = forward_backward().detach()
            torch.cuda.current_stream(dev).wait_stream(side)
            return loss
        if graph is None and coords.is_cuda:
            # the captured backward allocates the gradients it rewrites
            opt.zero_grad(set_to_none=True)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = forward_backward().detach()
        if graph is not None:
            graph.replay()
            return out
        opt.zero_grad(set_to_none=True)
        return forward_backward().detach()

    return idx, step


def _train_surrogate(model, coords, params_in, psi, cfg, seed=0, verbose=False):
    """Adam on the MSE of model(coords, params) against psi, `cfg["Epochs"]`
    epochs of whole minibatches, each epoch's order a permutation drawn up
    front from a CPU generator seeded with `seed`. Trains `model` in place
    (on the card through `_surrogate_step`'s CUDA graph); returns the last
    step's loss (a tensor on the model's device)."""
    n = params_in.shape[0]
    idx, step = _surrogate_step(model, coords, params_in, psi, cfg)
    bs = idx.numel()
    gen = torch.Generator().manual_seed(seed)
    perms = [torch.randperm(n, generator=gen) for _ in range(cfg["Epochs"])]
    perms = torch.stack(perms).to(coords.device) if perms else None
    loss = None
    for ep in range(cfg["Epochs"]):
        for i in range(0, n - bs + 1, bs):
            idx.copy_(perms[ep, i:i + bs])
            loss = step()
        if verbose and ep % 50 == 0:
            print(f"{type(model).__name__} epoch {ep}: loss {float(loss):.3e}")
    return loss


def run_freegsnke(config: dict | None = None, seed: int = 0, verbose: bool = True,
                  device="cuda"):
    """Returns `cppre`'s keys (mse, alphas, coverage_marginal,
    coverage_joint), "model" (the trained surrogate), "train_time"
    (seconds, ending in a synchronize on the card) and the GS residuals of
    truth and prediction on the calibration and prediction splits
    ("res_true_cal", "res_pred_cal", "res_pred", "res_true_pred")."""
    cfg = dict(CONFIG, **(config or {}))
    R, Z, pf, psi = solovev_batch(cfg["n_total"], cfg["NR"], cfg["NZ"], seed=seed)
    dr, dz = float(R[1] - R[0]), float(Z[1] - Z[0])

    RR, ZZ = np.meshgrid(R, Z, indexing="ij")
    coords = torch.as_tensor(np.stack([RR, ZZ])[None].repeat(len(pf), 0), dtype=torch.float32,
                             device=device)
    psi_t = torch.as_tensor(psi[:, None], device=device)            # [n, 1, NR, NZ]
    norm_rz, norm_psi = MinMaxNormalizer(coords), MinMaxNormalizer(psi_t)
    coords_e, psi_e = norm_rz.encode(coords), norm_psi.encode(psi_t)
    pf = torch.as_tensor(pf, device=device)

    n_train = cfg["n_train"]
    model = _make_surrogate(cfg, pf.shape[1], seed, device)
    t0 = time.perf_counter()
    _train_surrogate(model, coords_e[:n_train], pf[:n_train], psi_e[:n_train], cfg, seed,
                     verbose)
    if coords.is_cuda:
        torch.cuda.synchronize(coords.device)
    train_time = time.perf_counter() - t0

    with torch.no_grad():
        pred_e = model(coords_e, pf)
        mse = float(torch.mean((pred_e - psi_e) ** 2))
        psi_pred = norm_psi.decode(pred_e)[:, 0]                    # [n, NR, NZ]
        pre = PRE_GradShafranov(R, dr, dz)
        res_pred, res_true = pre(psi_pred), pre(psi_t[:, 0])

        rest = psi.shape[0] - n_train
        ncal = n_train + int(0.5 * rest)
        cal, prd = slice(n_train, ncal), slice(ncal, None)
        marg = marginal_cp(res_true[cal], res_pred[cal], res_pred[prd], res_true[prd])
        joint = joint_cp(res_true[cal], res_pred[cal], res_pred[prd], res_true[prd], eps=1e-6)
    results = {"mse": mse, "alphas": marg["alphas"], "coverage_marginal": marg["coverage"],
               "coverage_joint": joint["coverage"], "model": model, "train_time": train_time,
               "res_true_cal": res_true[cal], "res_pred_cal": res_pred[cal],
               "res_pred": res_pred[prd], "res_true_pred": res_true[prd]}
    if verbose:
        print(f"{type(model).__name__} MSE {mse:.3e}")
        for a, c1, c2 in zip(results["alphas"], marg["coverage"], joint["coverage"]):
            print(f"alpha={a:.2f}  marginal={c1:.3f}  joint={c2:.3f}")
    return results


def load_efit_csv(path: str, n_grid: int = 33, nrows: int | None = 10000):
    """Reference EFIT dataset ingestion (`EFIT/EFIT_cp.py:36-53`): headerless
    CSV, column 0 an index, then 6 flattened n_grid^2 blocks per row
    (psi_true, psi_pred, pff_true, pff_pred, gs_true, gs_pred). Returns
    (psi_true, psi_pred) as [N, n_grid, n_grid] float32 numpy arrays."""
    raw = np.loadtxt(path, delimiter=",", max_rows=nrows, dtype=np.float32)
    raw = np.atleast_2d(raw)[:, 1:]  # drop the index column
    ncell = n_grid * n_grid
    if raw.shape[1] < 2 * ncell:
        raise ValueError(
            f"EFIT CSV rows have {raw.shape[1]} values; expected >= "
            f"{2 * ncell} (psi_true + psi_pred blocks of {ncell})")
    psi_true = raw[:, :ncell].reshape(-1, n_grid, n_grid)
    psi_pred = raw[:, ncell:2 * ncell].reshape(-1, n_grid, n_grid)
    return psi_true, psi_pred


def run_efit(psi_true=None, psi_pred=None, R=None, dr=None, dz=None, alphas=None,
             seed: int = 0, verbose: bool = True, plots_dir: str | None = None, wall=None,
             device="cuda"):
    """Marginal CP over (psi_true, psi_pred) pairs (`EFIT/EFIT_cp.py:36-110`):
    the first 60 % calibrate, the rest are predicted. Without arguments, a
    synthetic Solov'ev ensemble (400 at 64^2) with predictions perturbed by
    0.003 N(0, 1) noise from `seed`. With `plots_dir`, saves the tokamak-wall
    contour overlay of a prediction residual and the per-cell CP bound,
    `efit_wall_contour.pdf` (needs matplotlib); `wall` optionally supplies
    the machine polyline [N, 2]. Returns `marginal_cp`'s dict."""
    if psi_true is not None and (R is None or dr is None or dz is None):
        raise ValueError("run_efit with explicit psi arrays requires R, dr, dz")
    Z = None
    if psi_true is None:
        R, Z, _, psi = solovev_batch(400, 64, 64, seed=seed)
        dr, dz = float(R[1] - R[0]), float(Z[1] - Z[0])
        rng = np.random.RandomState(seed)
        psi_true = psi
        psi_pred = psi + 0.003 * rng.standard_normal(psi.shape).astype(np.float32)
    pre = PRE_GradShafranov(R, dr, dz)
    with torch.no_grad():
        res_true = pre(torch.as_tensor(np.asarray(psi_true), dtype=torch.float32,
                                       device=device))
        res_pred = pre(torch.as_tensor(np.asarray(psi_pred), dtype=torch.float32,
                                       device=device))
        ncal = int(0.6 * res_true.shape[0])
        cal, prd = slice(0, ncal), slice(ncal, None)
        out = marginal_cp(res_true[cal], res_pred[cal], res_pred[prd], res_true[prd])
    if verbose:
        for a, c in zip(out["alphas"], out["coverage"]):
            print(f"alpha={a:.2f}  coverage={c:.3f}")
    if plots_dir is not None:
        import os

        import matplotlib.pyplot as plt

        from ..cp.inductive import calibrate
        from ..utils.plot_tools import wall_contour_figure

        os.makedirs(plots_dir, exist_ok=True)
        if Z is None:
            nz = np.asarray(psi_true).shape[-1]
            Z = (np.arange(nz) - (nz - 1) / 2.0) * dz
        # the reference's "Residual and Error Bar" overlay: one prediction
        # residual against the per-cell qhat at alpha=0.5
        q_plot = calibrate(torch.abs(res_true[cal] - res_pred[cal]), ncal, 0.5)
        fig = wall_contour_figure(np.asarray(R).reshape(-1)[1:-1], np.asarray(Z).reshape(-1)[1:-1],
                                  res_pred[prd][0], q_plot, wall=wall,
                                  save_path=os.path.join(plots_dir, "efit_wall_contour.pdf"))
        plt.close(fig)
    return out


if __name__ == "__main__":
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = sys.argv[1] if len(sys.argv) > 1 else "freegsnke"
    run_freegsnke() if mode == "freegsnke" else run_efit()
