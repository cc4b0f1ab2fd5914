"""2-D wave equation, Fourier pseudospectral: u_tt = c^2 (u_xx + u_yy)
(port of `cppre.solvers.wave2d_spectral`).

`Wave2D(Nx, x_min, x_max, tend, c)` with `.dt`, `.dx`, `.initialise(Lambda,
aa, bb)` / `.vv`, `.solve(Lambda, aa, bb)` returning `(x, y, t, u [Nt, Nx,
Ny])`, `.solve_batch(params [n, 3])` and `.solve_from(u0)`. The IC is a
Gaussian bump `u0 = exp(-Lambda ((x-aa)^2 + (y-bb)^2))` at rest (u_t(0) = 0).

Scheme: leapfrog in time, exact spectral Laplacian (periodic), 101 time
frames over [0, tend] (more with `dt_scale < 1`). The Laplacian is
`torch.fft.fft2`/`ifft2` over the last two axes in complex64 on the
solver's device (the card unless the caller asks for the CPU); the JAX
`lax.scan` is a Python loop, and a batch of designs steps together.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Wave2D", "wave_solve_batch"]

_NT = 101  # time frames incl. t=0


def _laplacian_fft(u, k2):
    return torch.fft.ifft2(-k2 * torch.fft.fft2(u)).real


@torch.no_grad()
def _leapfrog(u0, k2, c: float, dt: float, nt: int):
    """u0 [..., Nx, Ny] at rest -> u [..., Nt, Nx, Ny]."""
    out = u0.new_empty(u0.shape[:-2] + (nt,) + u0.shape[-2:])
    lap0 = _laplacian_fft(u0, k2)
    u1 = u0 + 0.5 * (c * dt) ** 2 * lap0
    out[..., 0, :, :], out[..., 1, :, :] = u0, u1
    um1, u = u0, u1
    for i in range(2, nt):
        um1, u = u, 2.0 * u - um1 + (c * dt) ** 2 * _laplacian_fft(u, k2)
        out[..., i, :, :] = u
    return out


class Wave2D:
    """OO wrapper matching the reference solver's surface; runs on `device`."""

    def __init__(self, Nx: int, x_min: float, x_max: float, tend: float, c: float,
                 dt_scale: float = 1.0, *, device="cuda"):
        """dt_scale < 1 refines the leapfrog step (Nt grows accordingly)
        while keeping the [0, tend] horizon; the default reproduces the
        reference's 101-frame grid."""
        self.Nx = Nx
        self.x_min, self.x_max = x_min, x_max
        self.tend, self.c = tend, c
        self.device = torch.device(device)
        self.x = np.linspace(x_min, x_max, Nx, endpoint=False, dtype=np.float32)
        self.y = self.x.copy()
        self.dx = float(self.x[1] - self.x[0])
        self.Nt = int(round((_NT - 1) / dt_scale)) + 1
        self.dt = tend / (self.Nt - 1)
        self.t = np.arange(self.Nt, dtype=np.float32) * self.dt
        k = 2 * np.pi * np.fft.fftfreq(Nx, d=self.dx)
        kx, ky = np.meshgrid(k, k, indexing="ij")
        # built in float64, stored in float32
        self._k2 = torch.tensor((kx**2 + ky**2).astype(np.float32), device=self.device)
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        self._X = torch.tensor(X, device=self.device)
        self._Y = torch.tensor(Y, device=self.device)
        self.vv = None
        # leapfrog + spectral Laplacian stability: c*dt*k_max < 2
        assert c * self.dt * float(np.max(np.abs(k))) * np.sqrt(2) < 2.0, "unstable dt"

    def _params(self, params):
        return torch.as_tensor(np.asarray(params, np.float32), device=self.device).reshape(-1, 3)

    def _u0(self, p):
        """[n, 3] (Lambda, aa, bb) -> the initial bumps [n, Nx, Ny]."""
        lam, aa, bb = (p[:, i, None, None] for i in range(3))
        return torch.exp(-lam * ((self._X - aa) ** 2 + (self._Y - bb) ** 2))

    def initialise(self, Lambda: float, aa: float, bb: float):
        self.vv = self._u0(self._params([Lambda, aa, bb]))[0].cpu().numpy()
        return self.vv

    def solve(self, Lambda: float = 20.0, aa: float = 0.25, bb: float = 0.25):
        """One design -> (x, y, t, u [Nt, Nx, Ny] tensor on the device)."""
        u = self.solve_batch([Lambda, aa, bb])[0]
        return self.x, self.y, self.t, u

    def solve_batch(self, params):
        """[n, 3] (Lambda, aa, bb) -> u [n, Nt, Nx, Ny] on the solver's device."""
        return _leapfrog(self._u0(self._params(params)), self._k2, self.c, self.dt, self.Nt)

    def solve_from(self, u0):
        """Integrate from an arbitrary at-rest initial field [Nx, Ny] (e.g.
        analytic standing waves for solver validation) -> [Nt, Nx, Ny]."""
        u0 = torch.as_tensor(np.asarray(u0, np.float32), device=self.device)
        return _leapfrog(u0, self._k2, self.c, self.dt, self.Nt)


def wave_solve_batch(params, Nx, x_min, x_max, tend, c, *, device="cuda"):
    sim = Wave2D(Nx, x_min, x_max, tend, c, device=device)
    return sim.x, sim.y, sim.t, sim.solve_batch(params)
