"""JOREK reduced-MHD PRE: cylindrical-geometry residuals with R-weighted
Poisson brackets over (rho, Phi, T).

Port of `cppre.residuals.jorek.PRE_JOREK` over `cppre_torch.ops.ConvOperator2d`:
the continuity residual (with the grid-scaled `norms=True` form), the
temperature residual (gamma = 5/3) and the equation selector, with the
physical coefficients D = 3.4, mu = 2.25e-6, K = 2.25e-7. Fields enter as
[BS, 3, Nt, NR, NZ] ordered (rho, Phi, T). This is the plain oracle of the
fused JOREK residual kernel (`cppre_torch.ops.kernels.jorek_residual_fused`,
K2) and of the JOREK instances of K1 and K3.

The default corrects the upstream D_y bug (see
`cppre_torch.ops.stencils.embed_kernel_3d`); ``legacy_y_axis=True``
reproduces the upstream residual values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.convops import ConvOperator2d

__all__ = ["PRE_JOREK"]

GAMMA = 5.0 / 3.0


class PRE_JOREK:
    EQUATIONS = ("continuity", "temperature")

    def __init__(self, R, dt: float, dR: float, dZ: float, D: float = 3.4, K: float = 2.25e-7,
                 mu: float = 2.25e-6, legacy_y_axis: bool = False, device="cuda"):
        """R: the major-radius grid, broadcastable against [..., NR, NZ]; a
        1-D grid is taken as [NR, 1]. It is held as float32 on `device`, the
        card unless the caller asks for the CPU."""
        if torch.is_tensor(R):
            R = R.detach().cpu().numpy()
        self.R = torch.as_tensor(np.asarray(R, np.float32), device=device)
        if self.R.ndim == 1:
            self.R = self.R[:, None]  # [NR, 1] broadcasts over Z
        self.dt, self.dR, self.dZ = dt, dR, dZ
        self.Dc, self.K, self.mu = D, K, mu
        self.D_t = ConvOperator2d("t", 1)
        self.D_R = ConvOperator2d("x", 1)
        self.D_Z = ConvOperator2d("y", 1, legacy_y_axis=legacy_y_axis)
        self.D_RR = ConvOperator2d("x", 2)
        self.D_ZZ = ConvOperator2d("y", 2, legacy_y_axis=legacy_y_axis)

    @staticmethod
    def _crop(res, boundary):
        return res if boundary else res[..., 1:-1, 1:-1, 1:-1]

    def _bracket(self, a, b):
        """R-weighted Poisson bracket [a, b] = dR(a) dZ(b) - dR(b) dZ(a)."""
        return self.D_R(a) * self.D_Z(b) - self.D_R(b) * self.D_Z(a)

    def residual_continuity(self, fields, boundary: bool = False, norms: bool = False):
        rho, phi = fields[:, 0], fields[:, 1]
        R = self.R
        if norms:
            res = (2 * self.dR * self.dZ * self.D_t(rho)
                   - self.dt * R * self._bracket(rho, phi)
                   - (2 * self.dt * self.dZ) * 2 * rho * self.D_Z(phi)
                   - (4 * self.dt) * self.Dc
                   * (self.D_RR(rho) + (1 / R) * self.D_R(rho) + self.D_ZZ(rho)))
        else:
            res = (self.D_t(rho) - R * self._bracket(rho, phi)
                   - 2 * rho * self.D_Z(phi)
                   - self.Dc * (self.D_RR(rho) + (1 / R) * self.D_R(rho) + self.D_ZZ(rho)))
        return self._crop(res, boundary)

    def residual_temperature(self, fields, boundary: bool = False):
        rho, phi, T = fields[:, 0], fields[:, 1], fields[:, 2]
        R = self.R
        res = (T * self.D_t(rho) + rho * self.D_t(T)
               - rho * R * self._bracket(T, phi)
               + T * R * self._bracket(rho, phi)
               + 2 * GAMMA * rho * T * self.D_Z(phi)
               + self.K * (self.D_RR(T) + (1 / R) * self.D_R(T) + self.D_ZZ(T)))
        return self._crop(res, boundary)

    def residual(self, fields, equation: str = "continuity", boundary: bool = False):
        if equation not in self.EQUATIONS:
            raise ValueError(f"unknown JOREK equation {equation!r}")
        return getattr(self, f"residual_{equation}")(fields, boundary)

    __call__ = residual
