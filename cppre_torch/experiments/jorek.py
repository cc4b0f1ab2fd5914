"""JOREK reduced-MHD CP experiment (port of `cppre.experiments.jorek`).

Three fields (rho, Phi, T) from JOREK multi-blob tokamak simulations,
cylindrical-geometry residuals with R-weighted Poisson brackets, field
normalisation by (1e20, 1e5, 1e6), a NaN scrub, a MinMax-normalised FNO
(T_in 10, step 10, T_out 40) and joint CP with the +1e-6 modulation guard.
The reference reads a 2000-simulation offline dataset; `run` takes such an
array (an .npz with key 'fields' [Nsim, 3, NR, NZ, Nt] and the grids 'R',
'Z', 't'), and otherwise makes the synthetic multi-blob family
`synthetic_blobs` (numpy, so a seed gives the JAX package the same data).
The residual is kernel K2's JOREK instance, `ops.kernels.jorek_residual_fused`
(its plain version, equal to `PRE_JOREK`, on the CPU); it reads R from a
table, so a non-affine grid runs the kernel too.

Run on the card: ``python -m cppre_torch.experiments.jorek [joint|marginal] [data.npz]``.
"""

from __future__ import annotations

import time

import numpy as np

from ..ops.kernels import jorek_residual_fused
from ..utils.validate import scrub_nan_sims
from .base2d import run_2d_cp

__all__ = ["CONFIG", "run", "scrub", "synthetic_blobs"]

CONFIG = {
    # reference `Joint/JOREK_residuals_CP.py:14-36`-style schema
    "Case": "JOREK", "Field": "rho, Phi, T", "Model": "FNO",
    "Epochs": 500, "Batch Size": 5, "Optimizer": "Adam",
    "Learning Rate": 0.005, "Scheduler Step": 100, "Scheduler Gamma": 0.5,
    "Normalisation Strategy": "Min-Max",
    "T_in": 10, "T_out": 40, "Step": 10, "Width_time": 16, "Modes": 8,
    "Variables": 3, "Loss Function": "LP",
    "n_train": 100, "n_cal": 100, "n_pred": 100,
    "equation": "continuity",
    # physical coefficients (:196-199)
    "D": 3.4, "mu": 2.25e-6, "K": 2.25e-7,
    # field normalisation divisors (:127-129)
    "field_norms": (1e20, 1e5, 1e6),
}


def scrub(fields, sim_names=None, bad_list=()):
    """NaN scrub + bad-run deletion (reference :131-142)."""
    return scrub_nan_sims(fields, sim_names, bad_list)


def synthetic_blobs(n: int, NR: int = 32, NZ: int = 32, Nt: int = 50, seed: int = 0):
    """Data-free stand-in: advecting/diffusing Gaussian blobs in (R, Z)
    with a rotating potential, shaped like the JOREK multi-blob data.
    Returns (R, Z, t, fields [n, 3, NR, NZ, Nt]), numpy float32."""
    rng = np.random.RandomState(seed)
    R = np.linspace(2.6, 3.4, NR).astype(np.float32)
    Z = np.linspace(-0.4, 0.4, NZ).astype(np.float32)
    t = np.linspace(0, 1, Nt).astype(np.float32)
    RR, ZZ = np.meshgrid(R, Z, indexing="ij")
    out = np.empty((n, 3, NR, NZ, Nt), np.float32)
    for i in range(n):
        r0 = rng.uniform(2.8, 3.2)
        z0 = rng.uniform(-0.2, 0.2)
        w = rng.uniform(0.05, 0.15)
        amp = rng.uniform(0.5, 1.5)
        for j, tt in enumerate(t):
            rc = r0 + 0.1 * np.sin(2 * np.pi * tt)
            zc = z0 + 0.1 * np.cos(2 * np.pi * tt)
            blob = amp * np.exp(-(((RR - rc) ** 2 + (ZZ - zc) ** 2)
                                  / (2 * (w + 0.05 * tt) ** 2)))
            out[i, 0, :, :, j] = 1.0 + blob                           # rho
            out[i, 1, :, :, j] = 0.1 * np.sin(2 * np.pi * tt) * blob  # Phi
            out[i, 2, :, :, j] = 1.0 + 0.5 * blob                     # T
    return R, Z, t, out


def run(mode: str = "joint", data_path: str | None = None, config: dict | None = None,
        seed: int = 0, verbose: bool = True, device="cuda", **cp_kwargs):
    """The experiment: the npz at `data_path` (divided by `field_norms`,
    then scrubbed) or `synthetic_blobs`, then `run_2d_cp` with the JOREK
    residual `cfg["equation"]` over R. Returns its results, plus
    "data_time" (the wall seconds to load or make the data)."""
    cfg = dict(CONFIG, **(config or {}))
    t0 = time.perf_counter()
    if data_path:
        z = np.load(data_path)
        fields, R, Z, t = z["fields"], z["R"], z["Z"], z["t"]
        norms = np.asarray(cfg["field_norms"], np.float32)
        fields = fields / norms[None, :, None, None, None]
        fields, _ = scrub(fields)
    else:
        n_total = cfg["n_train"] + cfg["n_cal"] + cfg["n_pred"]
        R, Z, t, fields = synthetic_blobs(n_total, seed=seed)
    data_time = time.perf_counter() - t0
    res = lambda f: jorek_residual_fused(f, R, Dc=cfg["D"], K=cfg["K"],
                                         equation=cfg["equation"])
    cp_kwargs.setdefault("eps", 1e-6)  # reference's modulation guard
    out = run_2d_cp(data=fields, residual_fn=res, cfg=cfg, mode=mode, seed=seed,
                    verbose=verbose, device=device, **cp_kwargs)
    out["data_time"] = data_time
    return out


if __name__ == "__main__":
    import sys

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(sys.argv[1] if len(sys.argv) > 1 else "joint",
        sys.argv[2] if len(sys.argv) > 2 else None)
