"""1-D viscous Burgers: u_t + u u_x = nu u_xx, periodic, Fourier
pseudospectral (port of `cppre.solvers.burgers1d`).

`Burgers1D(Nx, Nt, x_min, x_max, t_end, nu)` with `.solve(a, b, c) ->
(u [Nt, Nx], x, dt)` and `.solve_batch(params [n, 3])`. The IC is
``u0 = a sin(pi x) + b sin(2 pi x) + c sin(3 pi x)``. Scheme: the exact
viscous integrating factor in spectral space and RK4 on the 2/3-dealiased
nonlinear term, `substeps` internal steps a stored frame. The wavenumbers,
the dealiasing mask and the factors E, E2 are float32 and computed as the
JAX package computes them; the FFTs are complex64 on the solver's device
(the card unless the caller asks for the CPU), and a batch of designs
steps together in a time loop.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Burgers1D", "burgers_solve_batch"]


@torch.no_grad()
def _burgers_solve(params, grid, Nx: int, Nt: int, substeps: int = 1):
    """params [n, 3] -> u [n, Nt, Nx]."""
    a, b, c = (params[:, i, None] for i in range(3))
    x, k, dealias, dt, nu = grid
    u0 = a * torch.sin(np.pi * x) + b * torch.sin(2 * np.pi * x) + c * torch.sin(3 * np.pi * x)

    h = dt / substeps  # internal (stable) step; frames stored every dt
    ik = 1j * k
    E = torch.exp(-nu * k**2 * h)
    E2 = torch.exp(-nu * k**2 * h / 2.0)

    def nonlinear(u_hat):
        u = torch.fft.ifft(u_hat).real
        return -0.5 * ik * torch.fft.fft(u * u) * dealias

    def substep(u_hat):
        # RK4 with the integrating factor
        k1 = nonlinear(u_hat)
        k2 = nonlinear(E2 * (u_hat + h / 2 * k1))
        k3 = nonlinear(E2 * u_hat + h / 2 * k2)
        k4 = nonlinear(E * u_hat + h * E2 * k3)
        return E * u_hat + h / 6 * (E * k1 + 2 * E2 * (k2 + k3) + k4)

    out = u0.new_empty((u0.shape[0], Nt, Nx))
    out[:, 0] = u0
    u_hat = torch.fft.fft(u0)
    for i in range(1, Nt):
        for _ in range(substeps):
            u_hat = substep(u_hat)
        out[:, i] = torch.fft.ifft(u_hat).real
    return out


class Burgers1D:
    """The reference solver's surface, on `device`."""

    def __init__(self, Nx: int, Nt: int, x_min: float, x_max: float, t_end: float, nu: float,
                 substeps: int | None = None, u_max_bound: float = 10.0, *, device="cuda"):
        self.Nx, self.Nt, self.nu = Nx, Nt, nu
        self.device = torch.device(device)
        self.x = np.linspace(x_min, x_max, Nx, endpoint=False, dtype=np.float32)
        self.dx = float(self.x[1] - self.x[0])
        self.dt = t_end / (Nt - 1)
        if substeps is None:
            # advective CFL <= 0.4 at the worst-case amplitude bound
            substeps = max(1, int(np.ceil(self.dt * u_max_bound / (0.4 * self.dx))))
        self.substeps = substeps
        k = 2 * np.pi * np.fft.fftfreq(Nx, d=self.dx)
        dealias = (np.abs(np.fft.fftfreq(Nx)) < 1.0 / 3.0).astype(np.float32)
        self._grid = (
            torch.tensor(self.x, device=self.device),
            torch.tensor(k, dtype=torch.float32, device=self.device),
            torch.tensor(dealias, device=self.device),
            self.dt,
            nu,
        )

    def _params(self, params):
        return torch.as_tensor(np.asarray(params, np.float32), device=self.device).reshape(-1, 3)

    def solve(self, a: float = 1.0, b: float = 1.0, c: float = 1.0):
        """One design -> (u [Nt, Nx] tensor on the device, x, dt)."""
        return self.solve_batch([a, b, c])[0], self.x, self.dt

    def solve_batch(self, params):
        """[n, 3] (a, b, c) design -> u [n, Nt, Nx] on the device."""
        return _burgers_solve(self._params(params), self._grid, self.Nx, self.Nt, self.substeps)


def burgers_solve_batch(params, Nx, Nt, x_min, x_max, t_end, nu, *, device="cuda"):
    sim = Burgers1D(Nx, Nt, x_min, x_max, t_end, nu, device=device)
    return sim.solve_batch(params), sim.x, sim.dt
