"""The NS momentum physics residual (CP-PRE `Joint/NS_Residuals_CP.py`).

fields [B, >=3, Nt, Nx, Ny] (u, v, p) -> [B, Nt-2, Nx-2, Ny-2]: central
differences on the interior, un-normalised (u[i+1] - u[i-1]), scaled by the
grid steps as the reference's residual scales them:

    res_x = D_t(u) dx dy + u D_x(u) dt dy + v D_y(u) dt dx - nu lap(u) dt + D_x(p) dt dy
    res_y = D_t(v) dx dy + u D_x(v) dt dx + v D_y(v) dt dy - nu lap(v) dt + D_y(p) dt dx
"""

from __future__ import annotations


def _i(f):
    return f[:, 1:-1, 1:-1, 1:-1]


def _dt(f):
    return f[:, 2:, 1:-1, 1:-1] - f[:, :-2, 1:-1, 1:-1]


def _dx(f):
    return f[:, 1:-1, 2:, 1:-1] - f[:, 1:-1, :-2, 1:-1]


def _dy(f):
    return f[:, 1:-1, 1:-1, 2:] - f[:, 1:-1, 1:-1, :-2]


def _lap(f):
    return (f[:, 1:-1, 2:, 1:-1] + f[:, 1:-1, :-2, 1:-1] + f[:, 1:-1, 1:-1, 2:]
            + f[:, 1:-1, 1:-1, :-2] - 4 * _i(f))


def residual(fields, r):
    dt, dx, dy, nu = r["dt"], r["dx"], r["dy"], r["nu"]
    u, v, p = fields[:, 0], fields[:, 1], fields[:, 2]
    ui, vi = _i(u), _i(v)
    res_x = (_dt(u) * (dx * dy) + ui * _dx(u) * (dt * dy) + vi * _dy(u) * (dt * dx)
             - nu * _lap(u) * dt + _dx(p) * (dt * dy))
    res_y = (_dt(v) * (dx * dy) + ui * _dx(v) * (dt * dx) + vi * _dy(v) * (dt * dy)
             - nu * _lap(v) * dt + _dy(p) * (dt * dx))
    return res_x + res_y
