"""Analytic Solov'ev equilibria: the Grad-Shafranov data source (port of
`cppre.solvers.solovev`, the same numpy code, so its arrays are bit for bit
cppre's).

Replaces the reference's offline tokamak data (EFIT CSV equilibria,
`EFIT/EFIT_cp.py:36-53`; FreeGSNKE Sobol PF-coil JSON, `GS_CP.py:69-85`)
with the classic analytic family (Cerfon & Freidberg, Phys. Plasmas 17,
032502 (2010) — public formulas): with the particular solution
psi_p = R^4/8 + A (R^2 ln R / 2 - R^4/8) one has
    Delta* psi_p = R^2 + A (1 - R^2),
and the up-down-symmetric homogeneous polynomials psi_1..psi_7 satisfy
Delta* psi_i = 0 exactly. A random coefficient vector therefore yields an
equilibrium whose GS residual is known in closed form — ideal for
validating `PRE_GradShafranov` and for data-free GS conformal prediction.
"""

from __future__ import annotations

import numpy as np

__all__ = ["solovev_psi", "solovev_batch", "gs_forcing"]


def _homogeneous(R, Z):
    lnR = np.log(R)
    return [
        np.ones_like(R),
        R**2,
        Z**2 - R**2 * lnR,
        R**4 - 4 * R**2 * Z**2,
        2 * Z**4 - 9 * R**2 * Z**2 + 3 * R**4 * lnR - 12 * R**2 * Z**2 * lnR,
        R**6 - 12 * R**4 * Z**2 + 8 * R**2 * Z**4,
        (8 * Z**6 - 140 * R**2 * Z**4 + 75 * R**4 * Z**2 - 15 * R**6 * lnR
         + 180 * R**4 * Z**2 * lnR - 120 * R**2 * Z**4 * lnR),
    ]


def solovev_psi(R, Z, A: float, coeffs) -> np.ndarray:
    """psi(R, Z) for one coefficient vector (A, c_1..c_7)."""
    RR, ZZ = np.meshgrid(np.asarray(R, np.float64), np.asarray(Z, np.float64),
                         indexing="ij")
    psi = RR**4 / 8.0 + A * (RR**2 * np.log(RR) / 2.0 - RR**4 / 8.0)
    for c, h in zip(coeffs, _homogeneous(RR, ZZ)):
        psi = psi + c * h
    return psi.astype(np.float32)


def gs_forcing(R, Z, A: float) -> np.ndarray:
    """The exact Delta* psi = R^2 + A (1 - R^2) (coefficient-independent)."""
    RR, _ = np.meshgrid(np.asarray(R, np.float64), np.asarray(Z, np.float64),
                        indexing="ij")
    return (RR**2 + A * (1.0 - RR**2)).astype(np.float32)


def solovev_batch(n: int, NR: int = 64, NZ: int = 64,
                  r_range=(0.6, 1.4), z_range=(-0.6, 0.6),
                  coeff_scale: float = 0.02, seed: int = 0):
    """Random family: params [n, 8] = (A, c_1..c_7), psi [n, NR, NZ].

    Returns (R, Z, params, psi)."""
    rng = np.random.RandomState(seed)
    R = np.linspace(*r_range, NR).astype(np.float32)
    Z = np.linspace(*z_range, NZ).astype(np.float32)
    params = np.concatenate(
        [rng.uniform(-0.2, 0.2, (n, 1)),                    # A
         rng.uniform(-coeff_scale, coeff_scale, (n, 7))],    # c_1..c_7
        axis=1,
    ).astype(np.float32)
    psi = np.stack([solovev_psi(R, Z, p[0], p[1:]) for p in params])
    return R, Z, params, psi
