"""Vector calculus on purely spatial fields [BS, C, Nx, Ny] with boundary
handling (port of `cppre.ops.vector_spatial`).

Each operator pads its input with a `BoundaryManager` (periodic by
default) and applies a *valid* `ConvOperatorSpatial`, so the output has the
input's spatial shape. The differentiable compressible-NS right-hand side
builds on these.
"""

from __future__ import annotations

import torch

from .boundary import BoundaryManager
from .convops import ConvOperatorSpatial

__all__ = ["dot", "cross", "vectorize", "Gradient", "Laplace", "Divergence", "Curl",
           "VectorGradient"]


def dot(a, b):
    return a[:, 0:1] * b[:, 0:1] + a[:, 1:2] * b[:, 1:2]


def cross(a, b):
    # the reference's '+' in place of '-'
    return a[:, 0:1] * b[:, 1:2] + a[:, 1:2] * b[:, 0:1]


def vectorize(a, b):
    return torch.cat((a, b), dim=1)


def _bc(taylor_order, boundary_cond):
    bc = BoundaryManager(kernel_size=(taylor_order + 1, taylor_order + 1))
    bc.set_all_boundaries(bc_type=boundary_cond)
    return bc


class Gradient:
    """Scalar -> its gradient on 2 channels."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2,
                 boundary_cond="periodic"):
        self.grad_x = ConvOperatorSpatial(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperatorSpatial(domain[1], order, scale, taylor_order)
        self.bc = _bc(taylor_order, boundary_cond)

    def __call__(self, input_x, input_y=None):
        if input_y is None:
            input_y = input_x
        return torch.cat((self.grad_x(self.bc.pad_signal(input_x)),
                          self.grad_y(self.bc.pad_signal(input_y))), dim=1)


class Laplace:
    """Scalar or componentwise vector Laplacian."""

    def __init__(self, domain=("x", "y"), order=2, scale=1.0, taylor_order=2,
                 boundary_cond="periodic", scalar=True):
        self.laplace = ConvOperatorSpatial(domain, order, scale, taylor_order)
        self.scalar = scalar
        self.bc = _bc(taylor_order, boundary_cond)

    def __call__(self, input_x, input_y=None):
        padded_x = self.bc.pad_signal(input_x)
        if self.scalar:
            return self.laplace(padded_x)
        if input_y is None:
            input_y = input_x
        padded_y = self.bc.pad_signal(input_y)
        return torch.cat((self.laplace(padded_x), self.laplace(padded_y)), dim=1)


class Divergence:
    """(u, v) -> du/dx + dv/dy."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2,
                 boundary_cond="periodic"):
        self.grad_x = ConvOperatorSpatial(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperatorSpatial(domain[1], order, scale, taylor_order)
        self.bc = _bc(taylor_order, boundary_cond)

    def __call__(self, input_x, input_y):
        return self.grad_x(self.bc.pad_signal(input_x)) + self.grad_y(self.bc.pad_signal(input_y))


class Curl:
    """(u, v) -> dv/dx - du/dy."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2,
                 boundary_cond="periodic"):
        self.grad_x = ConvOperatorSpatial(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperatorSpatial(domain[1], order, scale, taylor_order)
        self.bc = _bc(taylor_order, boundary_cond)

    def __call__(self, input_x, input_y):
        return self.grad_x(self.bc.pad_signal(input_y)) - self.grad_y(self.bc.pad_signal(input_x))


class VectorGradient:
    """(du/dx)^2 + (dv/dy)^2 + 2 (du/dy)(dv/dx)."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2,
                 boundary_cond="periodic"):
        self.grad_x = ConvOperatorSpatial(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperatorSpatial(domain[1], order, scale, taylor_order)
        self.bc = _bc(taylor_order, boundary_cond)

    def __call__(self, input_x, input_y):
        px, py = self.bc.pad_signal(input_x), self.bc.pad_signal(input_y)
        return (self.grad_x(px) ** 2 + self.grad_y(py) ** 2
                + 2 * self.grad_y(px) * self.grad_x(py))
