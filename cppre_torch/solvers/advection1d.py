"""1-D linear advection: u_t + v u_x = 0, periodic, Gaussian pulse IC
(port of `cppre.solvers.advection1d`).

`Advection1D(Nx, Nt, x_min, x_max, t_end)` with `.dt`, `.dx`,
`.initializeU(xc, amp)` / `.u`, `.solve(xc, amp, v)` returning
`(x, t, u_soln [Nt, Nx], u_exact [Nt, Nx])` and `.solve_batch(params [n, 2],
v)`: first-order upwind (periodic `torch.roll`) and the exact advected
profile. The IC is ``u0 = exp(-amp (x - xc)^2)``. The JAX `lax.scan` is a
time loop here, and a batch of designs steps together on the solver's
device (the card unless the caller asks for the CPU), in float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Advection1D", "advection_solve", "advection_solve_batch"]


def _gaussian_ic(x, xc, amp):
    return torch.exp(-amp * (x - xc) ** 2)


def _mod(a, b):
    """`jnp.mod`: the remainder with the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


@torch.no_grad()
def advection_solve(params, v, grid, Nx: int, Nt: int):
    """Upwind FD + exact solution for a batch. params [n, 2] = (xc, amp);
    grid = (x tensor [Nx], dx, dt). Returns (u_soln, u_exact), each
    [n, Nt, Nx] on x's device."""
    xc, amp = params[:, 0, None], params[:, 1, None]
    x, dx, dt = grid
    u = _gaussian_ic(x, xc, amp)
    cfl = v * dt / dx
    u_soln = u.new_empty((u.shape[0], Nt, Nx))
    u_soln[:, 0] = u
    for i in range(1, Nt):
        # first-order upwind (v > 0), periodic wrap
        u = u - cfl * (u - torch.roll(u, 1, dims=-1))
        u_soln[:, i] = u

    t = torch.arange(Nt, dtype=torch.float32, device=x.device) * dt
    L = x[-1] - x[0] + dx
    # exact: the profile advected with periodic wrapping
    xs = _mod(x[None, :] - v * t[:, None] - x[0], L) + x[0]
    u_exact = _gaussian_ic(xs[None], xc[..., None], amp[..., None])
    return u_soln, u_exact


class Advection1D:
    """The reference solver's surface, on `device`."""

    def __init__(self, Nx: int, Nt: int, x_min: float, x_max: float, t_end: float, *,
                 device="cuda"):
        self.Nx, self.Nt = Nx, Nt
        self.x_min, self.x_max, self.t_end = x_min, x_max, t_end
        self.device = torch.device(device)
        self.x = np.linspace(x_min, x_max, Nx, dtype=np.float32)
        self.dx = float(self.x[1] - self.x[0])
        self.dt = t_end / (Nt - 1)
        self.t = np.arange(Nt, dtype=np.float32) * self.dt
        self._x = torch.tensor(self.x, device=self.device)
        self.u = None

    def _params(self, params):
        return torch.as_tensor(np.asarray(params, np.float32), device=self.device).reshape(-1, 2)

    def initializeU(self, xc: float, amp: float):
        p = self._params([xc, amp])
        self.u = _gaussian_ic(self._x, p[:, 0], p[:, 1]).cpu().numpy()
        return self.u

    def solve(self, xc: float, amp: float, v: float):
        """One design -> (x, t, u_soln [Nt, Nx], u_exact [Nt, Nx]), the
        fields as tensors on the device."""
        u_soln, u_exact = advection_solve(self._params([xc, amp]), v,
                                          (self._x, self.dx, self.dt), self.Nx, self.Nt)
        return self.x, self.t, u_soln[0], u_exact[0]

    def solve_batch(self, params, v: float):
        """[n, 2] (xc, amp) design -> u_soln [n, Nt, Nx] on the device."""
        return advection_solve(self._params(params), v, (self._x, self.dx, self.dt), self.Nx,
                               self.Nt)[0]


def advection_solve_batch(params, v, Nx, Nt, x_min, x_max, t_end, *, device="cuda"):
    """Functional batch API: params [n, 2] -> (x, t, u [n, Nt, Nx])."""
    sim = Advection1D(Nx, Nt, x_min, x_max, t_end, device=device)
    return sim.x, sim.t, sim.solve_batch(params, v)
