"""The wave-equation physics residual (CP-PRE `Joint/Wave_Residuals_CP.py`).

fields [B, 1, Nt, Nx, Ny] -> [B, Nt-2, Nx-2, Ny-2]: the composite stencil
u_tt - (c dt / dx)^2 (u_xx + u_yy), central differences on the interior,
the coefficient taken in float32 as the reference composes it.
"""

from __future__ import annotations

import numpy as np


def residual(fields, r):
    u = fields[:, 0]
    s = float(np.float32((r["c"] * r["dt"] / r["dx"]) ** 2))
    c = u[:, 1:-1, 1:-1, 1:-1]
    u_tt = u[:, 2:, 1:-1, 1:-1] - 2 * c + u[:, :-2, 1:-1, 1:-1]
    lap = (u[:, 1:-1, 2:, 1:-1] + u[:, 1:-1, :-2, 1:-1] + u[:, 1:-1, 1:-1, 2:]
           + u[:, 1:-1, 1:-1, :-2] - 4 * c)
    return u_tt - s * lap
