"""Grad-Shafranov PRE: the GS operator residual for tokamak equilibria.

Port of `cppre.residuals.gs.PRE_GradShafranov` over
`cppre_torch.ops.ConvOperator2d`:

    Delta* psi = D_RR(psi) dz^2 - (1/R) D_R(psi) dz^2 dr + D_ZZ(psi) dr^2

(norms=True, grid-scaled) or the unscaled form (norms=False). psi enters as
[BS, NR, NZ] or [BS, Nt, NR, NZ]. It has no kernel: plain torch on every
device, as it is XLA in `cppre`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.convops import ConvOperator2d

__all__ = ["PRE_GradShafranov"]


class PRE_GradShafranov:
    def __init__(self, R, dr: float, dz: float, legacy_y_axis: bool = False):
        R = R if isinstance(R, torch.Tensor) else torch.as_tensor(np.asarray(R))
        self.R = R[:, None] if R.ndim == 1 else R          # [NR, 1]
        self.dr, self.dz = dr, dz
        self.D_R = ConvOperator2d("x", 1)
        self.D_RR = ConvOperator2d("x", 2)
        self.D_ZZ = ConvOperator2d("y", 2, legacy_y_axis=legacy_y_axis)

    def residual(self, psi, boundary: bool = False, norms: bool = True):
        """psi: [BS, NR, NZ] (or [BS, Nt, NR, NZ] with a real time axis).

        The crop removes one spatial cell per side and leaves the time axis
        whole: the operator is purely spatial, so only the spatial halo is
        invalid (a singleton time axis would crop to length zero)."""
        squeeze = psi.ndim == 3
        if squeeze:
            psi = psi[:, None]  # dummy time axis: the stencils live in the
            # t-centre plane, so the SAME convolution over Nt=1 is exact
        inv_r = 1 / self.R.to(device=psi.device, dtype=psi.dtype)
        if norms:
            res = (self.D_RR(psi) * self.dz**2
                   - inv_r * self.D_R(psi) * self.dz**2 * self.dr
                   + self.D_ZZ(psi) * self.dr**2)
        else:
            res = self.D_RR(psi) - inv_r * self.D_R(psi) + self.D_ZZ(psi)
        if not boundary:
            res = res[..., 1:-1, 1:-1]
        return res[:, 0] if squeeze else res

    __call__ = residual
