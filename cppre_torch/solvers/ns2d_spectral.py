"""2-D incompressible Navier-Stokes, vorticity-streamfunction pseudospectral
(port of `cppre.solvers.ns2d_spectral`).

`NavierStokes2D(N, tStart, tEnd, dt, nu, L, aa, bb)` with `.solve() ->
(u, v, p, w, x, t, err)`, fields [Nt, N, N]; the NS flagship runs N=400,
dt=1e-3, nu=1e-3, tEnd=0.5 and slices `[::10, ::4, ::4]`.

The IC is a periodic double-vortex streamfunction parameterised by the LHS
design (aa, bb) in [0.5, 1]^2:
    psi0 = (aa/(2 pi)) sin(2 pi x/L) sin(2 pi y/L)
         + (bb/(2 pi)) cos(2 pi x/L) cos(2 pi y/L),
    u = d(psi)/dy, v = -d(psi)/dx   (divergence-free by construction).

Scheme: vorticity equation w_t + u.grad(w) = nu lap(w); exact viscous
integrating factor + RK4 on the 2/3-dealiased advection term; streamfunction
by spectral Poisson solve; pressure recovered per stored frame from
lap(p) = 2 (u_x v_y - u_y v_x); `err` is max |div(u)| over stored frames.
Every `store_every`-th frame is stored.

`torch.fft` in complex64 on the solver's device (the card unless the caller
asks for the CPU), as the JAX package uses `jnp.fft` outside any Pallas
kernel; its `lax.scan`/`fori_loop` are Python loops. A batch of designs
runs in one call (`solve_batch`): every FFT is batched over the leading
axis.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NavierStokes2D", "ns_solve", "ns_solve_batch"]


def _make_grid(N: int, L: float):
    x = np.linspace(0.0, L, N, endpoint=False, dtype=np.float32)
    dx = float(x[1] - x[0])
    k = 2 * np.pi * np.fft.fftfreq(N, d=dx)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    k2 = kx**2 + ky**2
    k2_inv = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    kcut = np.max(np.abs(k)) * 2.0 / 3.0
    dealias = ((np.abs(kx) < kcut) & (np.abs(ky) < kcut)).astype(np.float32)
    return x, dx, kx, ky, k2, k2_inv, dealias


def _re(z):
    return torch.fft.ifft2(z).real


@torch.no_grad()
def _ns_solve(params, grid, n_steps: int, store_every: int):
    """params [n, 2] (aa, bb) -> (u, v, p, w) each [n, Nt, N, N] and the
    largest |div u| of each design [n]."""
    X, Y, kx, ky, k2, k2_inv, dealias, dt, nu, L = grid
    aa, bb = params[:, 0, None, None], params[:, 1, None, None]
    two_pi = 2 * np.pi / L
    psi0 = (aa / two_pi) * torch.sin(two_pi * X) * torch.sin(two_pi * Y) + (
        bb / two_pi) * torch.cos(two_pi * X) * torch.cos(two_pi * Y)
    w_hat = k2 * torch.fft.fft2(psi0)  # w = -lap(psi)

    ikx, iky = 1j * kx, 1j * ky
    E = torch.exp(-nu * k2 * dt)
    E2 = torch.exp(-nu * k2 * dt / 2.0)

    def velocity(w_hat):
        psi_hat = w_hat * k2_inv
        return _re(iky * psi_hat), _re(-ikx * psi_hat)

    def nonlinear(w_hat):
        u, v = velocity(w_hat)
        wx = _re(ikx * w_hat)
        wy = _re(iky * w_hat)
        return -torch.fft.fft2(u * wx + v * wy) * dealias

    def rk4_step(w_hat):
        k1 = nonlinear(w_hat)
        k2_ = nonlinear(E2 * (w_hat + dt / 2 * k1))
        k3 = nonlinear(E2 * w_hat + dt / 2 * k2_)
        k4 = nonlinear(E * w_hat + dt * E2 * k3)
        return E * w_hat + dt / 6 * (E * k1 + 2 * E2 * (k2_ + k3) + k4)

    def fields_of(w_hat):
        u, v = velocity(w_hat)
        ux = _re(ikx * torch.fft.fft2(u))
        uy = _re(iky * torch.fft.fft2(u))
        vx = _re(ikx * torch.fft.fft2(v))
        vy = _re(iky * torch.fft.fft2(v))
        rhs = 2.0 * (ux * vy - uy * vx)
        p = _re(-torch.fft.fft2(rhs) * k2_inv)
        w = _re(torch.fft.fft2(vx - uy))
        div_err = torch.amax(torch.abs(ux + vy), dim=(-2, -1))
        return u, v, p, w, div_err

    frames = [fields_of(w_hat)]
    for _ in range(n_steps // store_every):
        for _ in range(store_every):
            w_hat = rk4_step(w_hat)
        frames.append(fields_of(w_hat))
    u, v, p, w = (torch.stack([f[i] for f in frames], dim=1) for i in range(4))
    err = torch.amax(torch.stack([f[4] for f in frames], dim=1), dim=1)
    return u, v, p, w, err


class NavierStokes2D:
    """OO wrapper matching the reference solver's surface; runs on `device`."""

    def __init__(self, N: int, tStart: float, tEnd: float, dt: float, nu: float, L: float,
                 aa: float = 1.0, bb: float = 1.0, store_every: int = 1, *, device="cuda"):
        self.N, self.dt, self.nu, self.L = N, dt, nu, L
        self.tStart, self.tEnd = tStart, tEnd
        self.aa, self.bb = aa, bb
        self.store_every = store_every
        self.n_steps = max(int(round((tEnd - tStart) / dt)), store_every)
        self.device = torch.device(device)
        x, dx, kx, ky, k2, k2_inv, dealias = _make_grid(N, L)
        self.x, self.dx = x, dx
        X, Y = np.meshgrid(x, x, indexing="ij")
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self._grid = (f32(X), f32(Y), f32(kx), f32(ky), f32(k2), f32(k2_inv), f32(dealias),
                      dt, nu, L)
        self.t = np.arange(self.n_steps // store_every + 1) * dt * store_every

    def _params(self, params):
        return torch.as_tensor(np.asarray(params, np.float32), device=self.device).reshape(-1, 2)

    def solve(self, aa: float | None = None, bb: float | None = None):
        """One design -> (u, v, p, w) [Nt, N, N] tensors, x, t, err."""
        p = self._params([self.aa if aa is None else aa, self.bb if bb is None else bb])
        u, v, pr, w, err = _ns_solve(p, self._grid, self.n_steps, self.store_every)
        return u[0], v[0], pr[0], w[0], self.x, self.t, float(err[0])

    def solve_batch(self, params):
        """[n, 2] -> (u, v, p, w) each [n, Nt, N, N] on the solver's device."""
        return _ns_solve(self._params(params), self._grid, self.n_steps, self.store_every)[:4]


def ns_solve(params, N, tStart, tEnd, dt, nu, L, store_every=1, *, device="cuda"):
    sim = NavierStokes2D(N, tStart, tEnd, dt, nu, L, store_every=store_every, device=device)
    return sim.solve(params[0], params[1])


def ns_solve_batch(params, N, tStart, tEnd, dt, nu, L, store_every=1, *, device="cuda"):
    sim = NavierStokes2D(N, tStart, tEnd, dt, nu, L, store_every=store_every, device=device)
    return sim.solve_batch(params), sim.x, sim.t
