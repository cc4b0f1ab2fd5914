"""2-D ideal MHD, finite volume with constrained transport (div B = 0)
(port of `cppre.solvers.mhd2d_constrained`).

`mhd_solve(N, boxsize, tEnd, a, b, c, dt, store_every) -> (rho, u, v, p,
bx, by, dt, x, err)` with fields [Nt, N, N], and `mhd_solve_batch(params
[n, 3], ...)` with fields [n, Nt, N, N]. The IC is a parameterised
Orszag-Tang vortex (gamma = 5/3): rho = (25/9) c, p_gas = (5/3) c,
v = a (-sin(2 pi y), sin(2 pi x)), B = (b / sqrt(4 pi)) (-sin(2 pi y),
sin(4 pi x)) from a vector potential on the faces, so div B = 0 exactly.
The returned `p` is the total pressure p_gas + |B|^2/2; `err` is
max |div B| dx over the stored frames.

Scheme: MUSCL reconstruction with Rusanov fluxes for the hydro + induction
system and constrained transport of face-centred B through corner EMFs.
Periodic domain, fixed dt, every `store_every`-th step stored.

The JAX code is written per simulation under `vmap`: it rolls axes 0/1 and
does its y-sweep by transposing each plane. Here a batch of designs steps
together as [n, N, N] tensors, so every roll acts on the last two axes
(x = -2, y = -1), and the y-sweep runs the x-sweep's arithmetic along
axis -1 instead of on transposed planes: the same operations on the same
values. The six primitives are stacked [n, 6, N, N] for the reconstruction,
so each shift is one launch for all of them. Frames are written straight
into one [n, 6, N, N, Nt] tensor, the experiment's layout, on the solver's
device (the card unless the caller asks for the CPU). On the card every
block of `store_every` steps after the first is one CUDA graph replay.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mhd_solve", "mhd_solve_batch"]

GAMMA = 5.0 / 3.0
_X, _Y = -2, -1                  # the grid axes of an [..., N, N] field
_SWAP = [0, 2, 1, 3, 5, 4]       # (rho, vx, vy, P, bx, by) -> (rho, vy, vx, P, by, bx)


def _roll(f, shift, axis):
    return torch.roll(f, shift, dims=axis)


def _get_conserved(rho, vx, vy, P_gas, bx, by):
    mx, my = rho * vx, rho * vy
    E = P_gas / (GAMMA - 1) + 0.5 * rho * (vx**2 + vy**2) + 0.5 * (bx**2 + by**2)
    return rho, mx, my, E


def _get_primitive(rho, mx, my, E, bx, by):
    vx, vy = mx / rho, my / rho
    P_gas = (GAMMA - 1) * (E - 0.5 * rho * (vx**2 + vy**2) - 0.5 * (bx**2 + by**2))
    return vx, vy, P_gas


def _max_speed(rho, vx, vy, P_gas, bx, by):
    b2 = bx**2 + by**2
    cf2 = (GAMMA * P_gas + b2) / rho  # fast-speed bound
    return torch.sqrt(vx**2 + vy**2) + torch.sqrt(torch.clamp(cf2, min=0.0))


def _flux_x(rho, vx, vy, P_gas, bx, by):
    """Ideal-MHD flux in x for (rho, mx, my, E, by)."""
    Pt = P_gas + 0.5 * (bx**2 + by**2)
    E = P_gas / (GAMMA - 1) + 0.5 * rho * (vx**2 + vy**2) + 0.5 * (bx**2 + by**2)
    f_rho = rho * vx
    f_mx = rho * vx**2 + Pt - bx**2
    f_my = rho * vx * vy - bx * by
    f_E = (E + Pt) * vx - bx * (vx * bx + vy * by)
    f_by = by * vx - bx * vy  # = -Ez
    return f_rho, f_mx, f_my, f_E, f_by


def _rusanov_x(qL, qR):
    """Rusanov flux at x-interfaces. q = (rho, vx, vy, P_gas, bx, by)."""
    fL, fR = _flux_x(*qL), _flux_x(*qR)
    smax = torch.maximum(_max_speed(*qL), _max_speed(*qR))
    consL = _get_conserved(*qL) + (qL[5],)  # by is conserved in the 1-D x-sweep
    consR = _get_conserved(*qR) + (qR[5],)
    return tuple(0.5 * (fl + fr) - 0.5 * smax * (cr - cl)
                 for fl, fr, cl, cr in zip(fL, fR, consL, consR))


def _sweep(prims, dx, axis):
    """Rusanov fluxes at the faces normal to `axis` (face i between cells
    i-1 and i): MUSCL states from central slopes, no Hancock half-step
    (with the reference's dt the spatial reconstruction dominates the
    error). prims [n, 6, N, N] ordered (rho, v_normal, v_tangent, P,
    b_normal, b_tangent)."""
    g = (_roll(prims, -1, axis) - _roll(prims, 1, axis)) / (2 * dx)
    half = 0.5 * dx * g
    qL = _roll(prims + half, 1, axis)
    qR = prims - half
    return _rusanov_x(qL.unbind(1), qR.unbind(1))


def _cell_B(bxf, byf):
    bx = 0.5 * (bxf + _roll(bxf, -1, _X))
    by = 0.5 * (byf + _roll(byf, -1, _Y))
    return bx, by


def _swap(prims):
    """prims[:, _SWAP], gathered by slices: no index tensor comes from the
    host, so a CUDA graph can capture it."""
    return torch.cat([prims[:, i:i + 1] for i in _SWAP], dim=1)


def _step(state, dx, dt):
    (rho_c, mx, my, E), bxf, byf = state
    bx, by = _cell_B(bxf, byf)
    vx, vy, P = _get_primitive(rho_c, mx, my, E, bx, by)
    prims = torch.stack((rho_c, vx, vy, P, bx, by), dim=1)

    Fx = _sweep(prims, dx, _X)                   # (rho, mx, my, E, by) at x-faces
    Fy = _sweep(_swap(prims), dx, _Y)            # (rho, my, mx, E, bx) at y-faces
    Gy = (Fy[0], Fy[2], Fy[1], Fy[3], Fy[4])     # (rho, mx, my, E, bx-flux)

    div_x = lambda F: (_roll(F, -1, _X) - F) / dx
    div_y = lambda F: (_roll(F, -1, _Y) - F) / dx
    rho_n = rho_c - dt * (div_x(Fx[0]) + div_y(Gy[0]))
    mx_n = mx - dt * (div_x(Fx[1]) + div_y(Gy[1]))
    my_n = my - dt * (div_x(Fx[2]) + div_y(Gy[2]))
    E_n = E - dt * (div_x(Fx[3]) + div_y(Gy[3]))

    # Constrained transport: corner EMF Ez from the induction fluxes.
    # Fx[4] = (by vx - bx vy) at x-faces = -Ez ; Gy[4] = (bx vy - by vx) at
    # y-faces = +Ez. Average the four adjacent face values to corners.
    emf_x, emf_y = -Fx[4], Gy[4]
    Ez = 0.25 * (emf_x + _roll(emf_x, 1, _Y) + emf_y + _roll(emf_y, 1, _X))
    # Faraday: d(bxf)/dt = -dEz/dy at x-faces, d(byf)/dt = +dEz/dx
    bxf_n = bxf - dt * (_roll(Ez, -1, _Y) - Ez) / dx
    byf_n = byf + dt * (_roll(Ez, -1, _X) - Ez) / dx
    return (rho_n, mx_n, my_n, E_n), bxf_n, byf_n


def _observe(state, dx):
    """(rho, u, v, total p, Bx, By) at the cell centres, and max |div B| dx."""
    (rho_c, mx, my, E), bxf, byf = state
    bx, by = _cell_B(bxf, byf)
    vx, vy, P = _get_primitive(rho_c, mx, my, E, bx, by)
    Pt = P + 0.5 * (bx**2 + by**2)
    divB = (_roll(bxf, -1, _X) - bxf + _roll(byf, -1, _Y) - byf) / dx
    return (rho_c, vx, vy, Pt, bx, by), torch.amax(torch.abs(divB), dim=(-2, -1)) * dx


def _flat(state):
    (rho, mx, my, E), bxf, byf = state
    return [rho, mx, my, E, bxf, byf]


def _unflat(f):
    return tuple(f[:4]), f[4], f[5]


def _block_graph(state, n: int, dx: float, dt: float):
    """(graph, buffers): `n` steps from the state held in `buffers` (copies
    of `state`), written back into them, captured as one CUDA graph. A step
    is ~200 small launches, which bound the eager loop on the host; a
    replay runs the same kernels in the same order, so the same bits."""
    buffers = [t.clone() for t in _flat(state)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s = _unflat(buffers)
        for _ in range(n):
            s = _step(s, dx, dt)
        for b, v in zip(buffers, _flat(s)):
            b.copy_(v)
    return graph, buffers


@torch.no_grad()
def _mhd_run(params, N: int, n_steps: int, store_every: int, dx: float, dt: float,
             graphs: bool = True):
    """params [n, 3] (a, b, c) -> fields [n, 6, N, N, Nt] (rho, u, v, p, Bx,
    By, the frame axis last) and err [n]. On the card (with `graphs`) the
    first `store_every` steps run eagerly and every later block of them is
    one replay of a CUDA graph (`_block_graph`)."""
    dev = params.device
    a, b, c = (params[:, i, None, None] for i in range(3))
    x = (torch.arange(N, dtype=torch.float32, device=dev) + 0.5) * dx
    X, Y = torch.meshgrid(x, x, indexing="ij")
    two_pi = 2 * np.pi
    ones = torch.ones((N, N), dtype=torch.float32, device=dev)

    rho0 = (25.0 / 9.0) * c * ones
    vx0 = -a * torch.sin(two_pi * Y)
    vy0 = a * torch.sin(two_pi * X)
    P0 = (5.0 / 3.0) * c * ones
    B0 = b / torch.sqrt(torch.tensor(4 * np.pi, dtype=torch.float32, device=dev))
    # face-centred B from a vector potential Az so div B = 0 exactly:
    # Az = B0 (cos(2 pi y)/(2 pi) + cos(4 pi x)/(4 pi)), taken at the
    # corners (i-1/2, j-1/2); bx_face = dAz/dy, by_face = -dAz/dx
    xf = torch.arange(N, dtype=torch.float32, device=dev) * dx
    Xf, Yf = torch.meshgrid(xf, xf, indexing="ij")
    Azc = B0 * (torch.cos(two_pi * Yf) / two_pi + torch.cos(2 * two_pi * Xf) / (2 * two_pi))
    bxf0 = (_roll(Azc, -1, _Y) - Azc) / dx
    byf0 = -(_roll(Azc, -1, _X) - Azc) / dx
    bx0, by0 = _cell_B(bxf0, byf0)
    state = (_get_conserved(rho0, vx0, vy0, P0, bx0, by0), bxf0, byf0)

    n_store = n_steps // store_every
    out = torch.empty((params.shape[0], 6, N, N, n_store + 1), dtype=torch.float32,
                      device=dev)
    fields, err = _observe(state, dx)
    out[..., 0] = torch.stack(fields, dim=1)
    graph = buffers = None
    for k in range(1, n_store + 1):
        if graph is not None:
            graph.replay()
        else:
            for _ in range(store_every):
                state = _step(state, dx, dt)
            if graphs and dev.type == "cuda" and k < n_store:
                graph, buffers = _block_graph(state, store_every, dx, dt)
                state = _unflat(buffers)
        fields, e = _observe(state, dx)
        out[..., k] = torch.stack(fields, dim=1)
        err = torch.maximum(err, e)
    return out, err


def _params(params, device):
    return torch.as_tensor(np.asarray(params, np.float32), device=device).reshape(-1, 3)


def mhd_solve(N: int, boxsize: float, tEnd: float, a: float, b: float, c: float,
              dt: float = 1e-4, store_every: int = 25, *, device="cuda"):
    """Reference-shaped entry point: returns (rho, u, v, p, bx, by, dt, x,
    err), the fields [Nt, N, N] tensors on `device`.

    Stored frames are every `store_every * dt` apart (the reference stores
    every step and slices `[::25]` after)."""
    dx = boxsize / N
    out, err = _mhd_run(_params([a, b, c], device), N, int(round(tEnd / dt)), store_every,
                        dx, dt)
    x = (np.arange(N) + 0.5) * dx
    return (*(out[0, i].permute(2, 0, 1) for i in range(6)), dt, x, float(err[0]))


def mhd_solve_batch(params, N: int, boxsize: float, tEnd: float, dt: float = 1e-4,
                    store_every: int = 25, *, device="cuda"):
    """[n, 3] design -> the six fields [n, Nt, N, N] on `device` (views of
    one [n, 6, N, N, Nt] tensor)."""
    out, _ = _mhd_run(_params(params, device), N, int(round(tEnd / dt)), store_every,
                      boxsize / N, dt)
    return tuple(out[:, i].permute(0, 3, 1, 2) for i in range(6))
