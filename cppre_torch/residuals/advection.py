"""1-D advection PRE: u_t + v u_x = 0 as one additive composite kernel
(port of `cppre.residuals.advection`).

``D.kernel = D_t.kernel + (v disc dt / dx) D_x.kernel`` over
`ConvOperator1d`, with `disc` the temporal subsampling of the data the
residual sees (2 in the marginal experiment, 1 in the joint one). Data
layout [BS, Nt, Nx]; interior crop [..., 1:-1, 1:-1] unless `boundary`.
"""

from __future__ import annotations

import numpy as np

from ..ops.convops import ConvOperator1d

__all__ = ["PRE_Advection"]


class PRE_Advection:
    def __init__(self, dt: float, dx: float, v: float = 1.0, disc: int = 1):
        D_t = ConvOperator1d("t", 1)
        D_x = ConvOperator1d("x", 1)
        self.D = ConvOperator1d()
        # float32 arithmetic, as the JAX package composes the kernel
        self.D.kernel = D_t.kernel + np.float32(v * disc * dt / dx) * D_x.kernel

    def residual(self, uu, boundary: bool = False):
        """uu: [BS, Nt, Nx] (already permuted from the FNO layout)."""
        res = self.D(uu)
        return res if boundary else res[..., 1:-1, 1:-1]

    __call__ = residual
