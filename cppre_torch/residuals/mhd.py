"""2-D ideal MHD PRE: five selectable residuals over 6 fields.

Port of `cppre.residuals.mhd.PRE_MHD` over `cppre_torch.ops.ConvOperator2d`:
continuity, momentum (with Lorentz terms), energy (gamma = 5/3,
p_gas = p - |B|^2/2), induction and Gauss's law div B, and the equation
selector. Fields enter as [BS, 6, Nt, Nx, Ny] ordered (rho, u, v, p, Bx, By).
This is the plain oracle of the fused MHD residual kernel
(`cppre_torch.ops.kernels.mhd_residual_fused`, K2).

The default corrects the upstream D_y bug (see
`cppre_torch.ops.stencils.embed_kernel_3d`); ``legacy_y_axis=True``
reproduces the upstream residual values.
"""

from __future__ import annotations

from ..ops.convops import ConvOperator2d

__all__ = ["PRE_MHD"]

GAMMA = 5.0 / 3.0


class PRE_MHD:
    EQUATIONS = ("continuity", "momentum", "energy", "induction", "gauss")

    def __init__(self, dt: float, dx: float, dy: float, legacy_y_axis: bool = False):
        self.dt, self.dx, self.dy = dt, dx, dy
        self.D_t = ConvOperator2d("t", 1)
        self.D_x = ConvOperator2d("x", 1)
        self.D_y = ConvOperator2d("y", 1, legacy_y_axis=legacy_y_axis)
        self.D_xx_yy = ConvOperator2d(("x", "y"), 2)

    @staticmethod
    def _crop(res, boundary):
        return res if boundary else res[..., 1:-1, 1:-1, 1:-1]

    def _unpack(self, fields):
        return tuple(fields[:, i] for i in range(6))

    def residual_continuity(self, fields, boundary: bool = False):
        rho, u, v, p, Bx, By = self._unpack(fields)
        res = (self.D_t(rho) + u * self.D_x(rho) + rho * self.D_x(u)
               + v * self.D_y(rho) + rho * self.D_y(v))
        return self._crop(res, boundary)

    def residual_momentum(self, fields, boundary: bool = False):
        rho, u, v, p, Bx, By = self._unpack(fields)
        D_x, D_y, D_t = self.D_x, self.D_y, self.D_t
        res_x = (D_t(u) + u * D_x(u) + (1 / rho) * D_x(p)
                 - 2 * (Bx / rho) * D_x(Bx) + v * D_y(u)
                 - (By / rho) * D_y(Bx) - (Bx / rho) * D_y(By))
        res_y = (D_t(v) + u * D_x(v) + (1 / rho) * D_y(p)
                 - 2 * (By / rho) * D_y(By) + v * D_y(v)
                 - (By / rho) * D_x(Bx) - (Bx / rho) * D_x(By))
        return self._crop(res_x, boundary) + self._crop(res_y, boundary)

    def residual_energy(self, fields, boundary: bool = False):
        rho, u, v, p, Bx, By = self._unpack(fields)
        D_x, D_y, D_t = self.D_x, self.D_y, self.D_t
        p_gas = p - 0.5 * (Bx**2 + By**2)
        res = (D_t(rho) + u * D_x(p) + v * D_y(p)
               + (GAMMA - 2) * (u * Bx + v * By) * (D_x(Bx) + D_y(By))
               + (GAMMA * p_gas + By**2) * D_x(u)
               + (GAMMA * p_gas + Bx**2) * D_y(v)
               - Bx * By * (D_y(u) + D_x(v)))
        return self._crop(res, boundary)

    def residual_induction(self, fields, boundary: bool = False):
        rho, u, v, p, Bx, By = self._unpack(fields)
        D_x, D_y, D_t = self.D_x, self.D_y, self.D_t
        res_x = D_t(Bx) - By * D_y(u) + Bx * D_y(v) - v * D_y(Bx) + u * D_y(By)
        res_y = D_t(By) + By * D_x(u) - Bx * D_x(v) - v * D_x(Bx) + u * D_x(By)
        return self._crop(res_x, boundary) + self._crop(res_y, boundary)

    def residual_gauss(self, fields, boundary: bool = False):
        _, _, _, _, Bx, By = self._unpack(fields)
        res = self.D_x(Bx) + self.D_y(By)
        return self._crop(res, boundary)

    def residual(self, fields, equation: str = "energy", boundary: bool = False):
        """Equation selector (reference `Joint/MHD_Residuals_CP.py:323-348`)."""
        if equation not in self.EQUATIONS:
            raise ValueError(f"unknown MHD equation {equation!r}")
        return getattr(self, f"residual_{equation}")(fields, boundary)

    __call__ = residual
