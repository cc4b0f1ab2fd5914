"""Classic ODE problems: closed-form solutions and ConvOperator0d
residuals (port of `cppre.node.problems`).

The ground truths are the closed forms, in float64 numpy as in `cppre`
(Bessel's through `scipy.special`). The residual composite kernels:
  SHO (x'' + (k/m) x = 0):      D = m*D_tt + dt^2*k*D_id
  DHO (m x'' + c x' + k x = 0): D = 2m*D_tt + dt*c*D_t + 2*dt^2*k*D_id
  Bessel / Cauchy-Euler: variable-coefficient residuals as pointwise
  `coeff * D(y)` on torch tensors.
No kernel: plain torch on the card, as `cppre` is XLA here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.convops import ConvOperator0d
from ..ops.stencils import stencil_1d

__all__ = [
    "sho_solution",
    "dho_solution",
    "bessel_solution",
    "cauchy_euler_solution",
    "sho_residual_kernel",
    "dho_residual_kernel",
    "bessel_residual",
    "cauchy_euler_residual",
    "bessel_state",
    "cauchy_euler_state",
]


# -- closed-form solutions ----------------------------------------------------

def sho_solution(t, x0=1.0, v0=0.0, m=1.0, k=1.0):
    w = np.sqrt(k / m)
    return x0 * np.cos(w * t) + (v0 / w) * np.sin(w * t)


def dho_solution(t, x0=1.0, v0=0.0, m=1.0, c=0.5, k=1.0):
    """The underdamped closed form."""
    zeta = c / (2 * np.sqrt(m * k))
    w0 = np.sqrt(k / m)
    assert zeta < 1, "underdamped only"
    wd = w0 * np.sqrt(1 - zeta**2)
    A = x0
    B = (v0 + zeta * w0 * x0) / wd
    return np.exp(-zeta * w0 * t) * (A * np.cos(wd * t) + B * np.sin(wd * t))


def bessel_solution(t, order: int = 0):
    from scipy.special import jv

    return jv(order, t)


def cauchy_euler_solution(t, a: float = 1.0, b: float = 1.0,
                          c1: float = 1.0, c2: float = 0.0):
    """x^2 y'' + a x y' + b y = 0 on t > 0: roots r of r(r-1) + a r + b = 0."""
    disc = (a - 1) ** 2 - 4 * b
    t = np.asarray(t, dtype=np.float64)
    if disc > 0:
        r1 = (-(a - 1) + np.sqrt(disc)) / 2
        r2 = (-(a - 1) - np.sqrt(disc)) / 2
        return c1 * t**r1 + c2 * t**r2
    if disc == 0:
        r = -(a - 1) / 2
        return (c1 + c2 * np.log(t)) * t**r
    re = -(a - 1) / 2
    im = np.sqrt(-disc) / 2
    return t**re * (c1 * np.cos(im * np.log(t)) + c2 * np.sin(im * np.log(t)))


def bessel_state(t, amp: float = 1.0, order: int = 0):
    """[Nt, 2] state A*[J_n, J_n'], float32: the reference samples
    amplitude*cos(phase) at x0, which keeps the trajectory on A*J_n."""
    from scipy.special import jv, jvp

    t = np.asarray(t, dtype=np.float64)
    return np.stack([amp * jv(order, t), amp * jvp(order, t, 1)],
                    axis=-1).astype(np.float32)


def cauchy_euler_state(t, c1: float = 1.0, c2: float = 0.0,
                       a: float = 1.0, b: float = 1.0):
    """[Nt, 2] state [y, y'], float32, y' by finite differences of the
    closed form (as the driver builds every problem's velocity channel)."""
    t = np.asarray(t, dtype=np.float64)
    y = cauchy_euler_solution(t, a=a, b=b, c1=c1, c2=c2)
    v = np.gradient(y, t)
    return np.stack([y, v], axis=-1).astype(np.float32)


# -- residuals ----------------------------------------------------------------

def sho_residual_kernel(dt: float, m: float = 1.0, k: float = 1.0):
    D_tt = stencil_1d(2, 2)
    D_id = stencil_1d(0, 2)
    D = ConvOperator0d()
    D.kernel = m * D_tt + dt**2 * k * D_id
    return D


def dho_residual_kernel(dt: float, m: float = 1.0, c: float = 0.5, k: float = 1.0):
    """2m*D_tt + dt*c*D_t + 2*dt^2*k*D_id (the doubled terms come from the
    reference's average of forward and backward first differences)."""
    D_tt = stencil_1d(2, 2)
    D_t = stencil_1d(1, 2)
    D_id = stencil_1d(0, 2)
    D = ConvOperator0d()
    D.kernel = 2 * m * D_tt + dt * c * D_t + 2 * dt**2 * k * D_id
    return D


def _pointwise(y, t):
    """(y as [B, Nt] float32, x = t as float32 [Nt] on y's device, dt, a
    function that restores y's leading shape)."""
    y = torch.as_tensor(y, dtype=torch.float32)
    lead = y.shape[:-1]
    x = torch.as_tensor(np.asarray(t), dtype=torch.float32).to(y.device)
    dt = float(t[1] - t[0])
    return y.reshape(-1, y.shape[-1]), x, dt, lambda r: r.reshape(lead + r.shape[-1:])


def bessel_residual(y, t, order: int = 0):
    """x^2 y'' + x y' + (x^2 - n^2) y per cell, for y [Nt] or [B, Nt]."""
    y, x, dt, back = _pointwise(y, t)
    D_tt = ConvOperator0d(order=2)
    D_t = ConvOperator0d(order=1)
    res = (x**2 * D_tt(y) / dt**2 + x * D_t(y) / (2 * dt)
           + (x**2 - order**2) * y)
    return back(res)


def cauchy_euler_residual(y, t, a: float = 1.0, b: float = 1.0):
    """x^2 y'' + a x y' + b y per cell, for y [Nt] or [B, Nt]."""
    y, x, dt, back = _pointwise(y, t)
    D_tt = ConvOperator0d(order=2)
    D_t = ConvOperator0d(order=1)
    res = x**2 * D_tt(y) / dt**2 + a * x * D_t(y) / (2 * dt) + b * y
    return back(res)
