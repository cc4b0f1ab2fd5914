"""Differentiable compressible-NS right-hand side and residuals (port of
`cppre.solvers.cns_differentiable`).

* `EulerFVRHS`: the compressible-Euler/NS right-hand side over
  [BS, 4, Nx, Ny] (rho, u, v, p), built from the vector operators of
  `ops.vector_spatial` (`Gradient`, `Laplace`, `Divergence`, `dot`) with
  periodic boundaries.
* `CNSResiduals`: the mass and momentum PRE forms over [BS, 4, Nt, Nx, Ny]
  with viscous coefficients eta, zeta, in the reference's grid-scaled
  variants, over `ConvOperator2d`.

Plain torch, as it is XLA in `cppre`: no Pallas kernel there, none here.
Every operator is shifted slices and products of its input, so torch
autograd differentiates both classes through the fields.
"""

from __future__ import annotations

import torch

from ..ops.convops import ConvOperator2d
from ..ops.vector_spatial import Divergence, Gradient, Laplace, dot

__all__ = ["EulerFVRHS", "CNSResiduals"]

GAMMA = 5.0 / 3.0


class EulerFVRHS:
    """Compressible-NS finite-volume operator-splitting right-hand side."""

    def __init__(self, dx: float, dy: float):
        self.dx, self.dy = dx, dy
        self.gradient = Gradient(scale=1.0 / dx, taylor_order=2, boundary_cond="periodic")
        self.laplace = Laplace(scale=1.0 / dx**2, taylor_order=2, boundary_cond="periodic",
                               scalar=False)
        self.divergence = Divergence(scale=1.0 / dx, taylor_order=2, boundary_cond="periodic")

    def __call__(self, fields):
        """fields: [BS, 4, Nx, Ny] -> RHS [BS, 4, Nx, Ny] (one time instance)."""
        rho, u, v, p = fields[:, 0:1], fields[:, 1:2], fields[:, 2:3], fields[:, 3:4]
        uv = fields[:, 1:3]
        rhs_mass = -rho * self.divergence(u, v) - dot(uv, self.gradient(rho))
        rhs_mom = (-dot(uv, self.gradient(u)) - dot(uv, self.gradient(v))
                   + self.laplace(u, v) + (1.0 / rho) * self.gradient(p))
        rhs_energy = -GAMMA * p * self.divergence(u, v) - dot(uv, self.gradient(rho))
        return torch.cat((rhs_mass, rhs_mom[:, 0:1], rhs_mom[:, 1:2], rhs_energy), dim=1)


class CNSResiduals:
    """Compressible-NS PRE forms over [BS, 4, Nt, Nx, Ny], in the
    reference's grid-scaled variants (its unscaled forms are overwritten
    before use)."""

    def __init__(self, dt: float = 0.05, dx: float = 0.0078, dy: float = 0.0078,
                 legacy_y_axis: bool = False):
        self.dt, self.dx, self.dy = dt, dx, dy
        self.D_t = ConvOperator2d("t", 1)
        self.D_x = ConvOperator2d("x", 1)
        self.D_y = ConvOperator2d("y", 1, legacy_y_axis=legacy_y_axis)
        self.D_xx_yy = ConvOperator2d(("x", "y"), 2)

    @staticmethod
    def _crop(res, boundary):
        return res if boundary else res[..., 1:-1, 1:-1, 1:-1]

    def mass(self, fields, boundary: bool = False):
        rho, u, v = fields[:, 0], fields[:, 1], fields[:, 2]
        res = (self.D_t(rho) * self.dx
               + rho * (self.D_x(u) + self.D_y(v)) * self.dt
               + u * self.D_x(rho) * self.dt
               + v * self.D_y(rho) * self.dt)
        return self._crop(res, boundary)

    def momentum(self, fields, params: dict, boundary: bool = False):
        rho, u, v, p = fields[:, 0], fields[:, 1], fields[:, 2], fields[:, 3]
        eta, zeta = params["eta"], params["zeta"]
        dt, dx = self.dt, self.dx
        div = self.D_x(u) + self.D_y(v)
        res_x = (rho * self.D_t(u) * 2 * dx**2 + u * self.D_x(u) * 2 * dt * dx
                 + v * self.D_y(u) * 2 * dt * dx + self.D_x(p) * 2 * dt * dx
                 - eta * self.D_xx_yy(u) * 4 * dt
                 - (zeta + eta / 3) * self.D_x(div) * 2 * dt)
        res_y = (rho * self.D_t(v) * 2 * dx**2 + u * self.D_x(v) * 2 * dt * dx
                 + v * self.D_y(v) * 2 * dt * dx + self.D_y(p) * 2 * dt * dx
                 - eta * self.D_xx_yy(v) * 4 * dt
                 - (zeta + eta / 3) * self.D_y(div) * 2 * dt)
        return self._crop(res_x + res_y, boundary)
