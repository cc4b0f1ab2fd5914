"""1-D viscous Burgers PRE: u_t + u u_x = nu u_xx (port of
`cppre.residuals.burgers`).

The nonlinear term forces the multi-kernel form:
    res = dx * D_t(u) + dt * u * D_x(u) - nu * D_xx(u) * (2 dt / dx)
over `ConvOperator1d`. Data layout [BS, Nt, Nx]; interior crop
[..., 1:-1, 1:-1] unless `boundary`.
"""

from __future__ import annotations

from ..ops.convops import ConvOperator1d

__all__ = ["PRE_Burgers"]


class PRE_Burgers:
    def __init__(self, dt: float, dx: float, nu: float = 0.002):
        self.dt, self.dx, self.nu = dt, dx, nu
        self.D_t = ConvOperator1d("t", 1)
        self.D_x = ConvOperator1d("x", 1)
        self.D_xx = ConvOperator1d("x", 2)

    def residual(self, uu, boundary: bool = False):
        res = (self.dx * self.D_t(uu)
               + self.dt * uu * self.D_x(uu)
               - self.nu * self.D_xx(uu) * (2 * self.dt / self.dx))
        return res if boundary else res[..., 1:-1, 1:-1]

    __call__ = residual
