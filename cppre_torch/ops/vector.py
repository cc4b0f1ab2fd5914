"""Vector calculus over ConvOperator2d for 2-D + time data [BS, Nt, Nx, Ny]
(port of `cppre.ops.vector`).

Thin compositions of scalar `ConvOperator2d`s. The reference's 2-D `cross`
is ``a0*b1 + a1*b0`` (a `+` where the true 2-D cross product has a `-`);
the residual pipelines depend on it, so `cross` keeps it and `cross_true`
is the correct one.
"""

from __future__ import annotations

import torch

from .convops import ConvOperator2d

__all__ = ["dot", "cross", "cross_true", "vectorize", "Divergence", "Gradient", "Curl",
           "Laplace"]


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1]


def cross(a, b):
    # the reference's '+' in place of '-'
    return a[0] * b[1] + a[1] * b[0]


def cross_true(a, b):
    return a[0] * b[1] - a[1] * b[0]


def vectorize(a, b):
    return torch.stack((a, b))


class Divergence:
    """div(u, v) = du/dx + dv/dy."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2):
        self.grad_x = ConvOperator2d(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperator2d(domain[1], order, scale, taylor_order)

    def __call__(self, input_x, input_y):
        return self.grad_x(input_x) + self.grad_y(input_y)


class Gradient:
    """grad(f) = stack(df/dx, df/dy)."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2):
        self.grad_x = ConvOperator2d(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperator2d(domain[1], order, scale, taylor_order)

    def __call__(self, input_x, input_y=None):
        if input_y is None:
            input_y = input_x
        return torch.stack((self.grad_x(input_x), self.grad_y(input_y)))


class Curl:
    """curl(u, v) = dv/dx - du/dy."""

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2):
        self.grad_x = ConvOperator2d(domain[0], order, scale, taylor_order)
        self.grad_y = ConvOperator2d(domain[1], order, scale, taylor_order)

    def __call__(self, input_x, input_y):
        return self.grad_x(input_y) - self.grad_y(input_x)


class Laplace:
    """Componentwise Laplacian."""

    def __init__(self, domain=("x", "y"), order=2, scale=1.0, taylor_order=2):
        self.laplace = ConvOperator2d(domain, order, scale, taylor_order)

    def __call__(self, input_x, input_y=None):
        if input_y is None:
            input_y = input_x
        return torch.stack((self.laplace(input_x), self.laplace(input_y)))
