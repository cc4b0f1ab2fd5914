"""PI / PISL loss factories over a residual operator (port of
`cppre.pi.losses`).

  PI(pred)        = mean(residual(pred)^2)                 (data-free)
  PISL(pred, y)   = mean((residual(pred) - residual(y))^2) (supervised by the residual)
  combined        = Lp(pred, y) + weight * PISL(pred, y)   (weight 1000)

`residual_fn` maps an FNO chunk [BS, Nvar, Nx, Ny, T] to its PRE, e.g.
`fno_chunk_residual(operator)`. `StencilOperator` is such an operator for a
constant stencil (the wave composite kernel) over kernel K8, differentiable
on the card through K8's adjoint.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.kernels import fused_stencil_same
from ..train.losses import lp_loss

__all__ = ["StencilOperator", "make_pi_loss", "make_pisl_loss", "make_combined_loss",
           "fno_chunk_residual"]


def fno_chunk_residual(pre_operator) -> Callable:
    """The reference's residual closure: crop the field boundaries of
    [BS, Nvar, Nx, Ny, T] (variable 0), permute to [BS, T-2, Nx-2, Ny-2]
    and apply the operator with `boundary=True`, the same-size residual of
    the cropped field."""

    def residual(field):
        f = field[:, 0, 1:-1, 1:-1, 1:-1]           # [BS, Nx-2, Ny-2, T-2]
        return pre_operator(f.permute(0, 3, 1, 2), boundary=True)

    return residual


class StencilOperator:
    """A constant odd k^3 stencil (e.g. `PRE_Wave(...).D.kernel`) as the PI
    loss's PRE operator over kernel K8: `fused_stencil_same`, K8 on the
    field [BS, Nt, Nx, Ny] zero-padded by k // 2, the same-size correlation
    `direct_conv(same=True)`; for the wave kernel `PRE_Wave(...)(field,
    boundary=True)`. On the card it launches K8 and differentiates through
    K8's adjoint; on the CPU it takes the plain version, which autograd
    differentiates. Only the `boundary=True` route that
    `fno_chunk_residual` calls exists."""

    def __init__(self, kernel):
        self.kernel = np.asarray(kernel, np.float32)

    def __call__(self, field, boundary: bool = True):
        if not boundary:
            raise ValueError("StencilOperator is the same-size (boundary=True) residual; "
                             "the valid interior is ops.kernels.fused_stencil_residual")
        return fused_stencil_same(field, self.kernel)


def make_pi_loss(residual_fn: Callable):
    def pi_loss(pred, target=None):
        return torch.mean(residual_fn(pred) ** 2)

    return pi_loss


def make_pisl_loss(residual_fn: Callable):
    def pisl_loss(pred, target):
        return torch.mean((residual_fn(pred) - residual_fn(target)) ** 2)

    return pisl_loss


def make_combined_loss(residual_fn: Callable, weight: float = 1000.0):
    pisl = make_pisl_loss(residual_fn)

    def combined(pred, target):
        return lp_loss(pred, target) + weight * pisl(pred, target)

    return combined
