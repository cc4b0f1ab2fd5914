"""2-D incompressible Navier-Stokes PRE: continuity + momentum + periodic BC.

Port of `cppre.residuals.ns.PRE_NS` over `cppre_torch.ops.ConvOperator2d`.
Fields enter as [BS, Nvar, Nt, Nx, Ny] with Nvar = (u, v, p). This is the
plain oracle of the fused momentum kernel
(`cppre_torch.ops.kernels.ns_momentum_residual_fused`).

The default corrects the upstream D_y bug (see
`cppre_torch.ops.stencils.embed_kernel_3d`); ``legacy_y_axis=True``
reproduces the upstream residual values.
"""

from __future__ import annotations

from ..ops.convops import ConvOperator2d

__all__ = ["PRE_NS"]


class PRE_NS:
    def __init__(self, dt: float, dx: float, dy: float, nu: float = 0.001,
                 legacy_y_axis: bool = False):
        self.dt, self.dx, self.dy, self.nu = dt, dx, dy, nu
        self.D_t = ConvOperator2d("t", 1)
        self.D_x = ConvOperator2d("x", 1)
        self.D_y = ConvOperator2d("y", 1, legacy_y_axis=legacy_y_axis)
        self.D_xx_yy = ConvOperator2d(("x", "y"), 2)

    @staticmethod
    def _crop(res, boundary):
        return res if boundary else res[..., 1:-1, 1:-1, 1:-1]

    def residual_continuity(self, fields, boundary: bool = False):
        """div u = 0 in stencil form: D_x(u) + (dx/dy) D_y(v)."""
        u, v = fields[:, 0], fields[:, 1]
        res = self.D_x(u) + (self.dx / self.dy) * self.D_y(v)
        return self._crop(res, boundary)

    def residual_momentum(self, fields, boundary: bool = False):
        """Scaled momentum residual summed over both components."""
        u, v, p = fields[:, 0], fields[:, 1], fields[:, 2]
        dt, dx, dy, nu = self.dt, self.dx, self.dy, self.nu
        res_x = (self.D_t(u) * dx * dy + u * self.D_x(u) * dt * dy
                 + v * self.D_y(u) * dt * dx - nu * self.D_xx_yy(u) * dt
                 + self.D_x(p) * dt * dy)
        res_y = (self.D_t(v) * dx * dy + u * self.D_x(v) * dt * dx
                 + v * self.D_y(v) * dt * dy - nu * self.D_xx_yy(v) * dt
                 + self.D_y(p) * dt * dx)
        return self._crop(res_x, boundary) + self._crop(res_y, boundary)

    residual = residual_momentum

    def periodic_bc_residual(self, field, wall: str = "right"):
        """Difference between opposite walls of a periodic field
        [BS, Nt, Nx, Ny], scaled by dx."""
        if wall == "top":
            res = field[..., 0, :] - field[..., -1, :]
        elif wall == "bottom":
            res = field[..., -1, :] - field[..., 0, :]
        elif wall == "left":
            res = field[..., :, 0] - field[..., :, -1]
        elif wall == "right":
            res = field[..., :, -1] - field[..., :, 0]
        else:
            raise ValueError(f"unknown wall {wall}")
        return res * self.dx

    __call__ = residual_momentum
