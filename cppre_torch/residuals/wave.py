"""2-D wave PRE: u_tt - (c dt/dx)^2 (u_xx + u_yy) as one composite kernel.

Port of `cppre.residuals.wave.PRE_Wave` over `cppre_torch.ops.ConvOperator2d`.
Data layout [BS, Nt, Nx, Ny]; the class also accepts the FNO layout
[BS, Nvar=1, Nt, Nx, Ny] and drops the variable axis. This is the plain
oracle of the fused stencil kernel (`cppre_torch.ops.kernels.wave_residual_fused`,
K8), which takes `PRE_Wave(...).D.kernel`.
"""

from __future__ import annotations

import numpy as np

from ..ops.convops import ConvOperator2d

__all__ = ["PRE_Wave"]


class PRE_Wave:
    def __init__(self, dt: float, dx: float, c: float = 1.0):
        D_tt = ConvOperator2d("t", 2)
        D_xx_yy = ConvOperator2d(("x", "y"), 2)
        self.D = ConvOperator2d()
        # float32 arithmetic, as the JAX package composes the kernel
        self.D.kernel = D_tt.kernel - np.float32((c * dt / dx) ** 2) * D_xx_yy.kernel

    def residual(self, uu, boundary: bool = False):
        if uu.ndim == 5:  # [BS, 1, Nt, Nx, Ny] FNO-permuted layout
            uu = uu[:, 0]
        res = self.D(uu)
        return res if boundary else res[..., 1:-1, 1:-1, 1:-1]

    __call__ = residual
