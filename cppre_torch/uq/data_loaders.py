"""In/out-of-distribution data loaders for the UQ comparison (port of
`cppre.uq.data_loaders`).

Per case: the solver's stacked FNO tensor on `device` (the card unless the
caller asks for the CPU), the matching PRE and the case's config.
`Dist: out` shifts the physics: half the wave speed for Wave, 10x the
viscosity for NS, and a disjoint stronger-field / lighter-fluid design box
for MHD.

The PRE is the case's class wrapped in `KernelPRE`: its interior residual
is a kernel's wrapper (K8 for the wave composite stencil, K2's NS momentum
instance, K2's MHD energy instance, the equation `PRE_MHD.residual`
defaults to), which on a CPU tensor takes the kernel's plain version; with
`boundary=True` it is the plain class.
"""

from __future__ import annotations

from ..ops.kernels import mhd_residual_fused, ns_momentum_residual_fused, wave_residual_fused
from ..residuals.mhd import PRE_MHD
from ..residuals.ns import PRE_NS
from ..residuals.wave import PRE_Wave

__all__ = ["KernelPRE", "load_wave", "load_ns", "load_mhd"]


class KernelPRE:
    """A PRE class whose interior residual is `kernel` (a kernel's wrapper)
    and whose `boundary=True` residual is the class's own.

    `residual(fields, boundary=False)` (also the call) takes the fields in
    the layout of `pre.residual`."""

    def __init__(self, pre, kernel):
        self.pre, self.kernel = pre, kernel

    def residual(self, fields, boundary: bool = False):
        if boundary:
            return self.pre.residual(fields, boundary=True)
        return self.kernel(fields.contiguous())

    __call__ = residual


def _wave_pre(dt, dx, c):
    pre = PRE_Wave(dt, dx, c=c)
    # [BS, 1, Nt, Nx, Ny] (FNO-permuted) or [BS, Nt, Nx, Ny], as PRE_Wave
    return KernelPRE(pre, lambda f: wave_residual_fused(
        (f[:, 0] if f.ndim == 5 else f).contiguous(), pre.D.kernel))


def _ns_pre(dt, dx, nu):
    pre = PRE_NS(dt, dx, dx, nu=nu)
    return KernelPRE(pre, lambda f: ns_momentum_residual_fused(f, dt, dx, dx, nu))


def _mhd_pre(dt, dx):
    return KernelPRE(PRE_MHD(dt, dx, dx), lambda f: mhd_residual_fused(f, "energy"))


def load_wave(dist: str = "in", n: int = 100, Nx: int = 64, seed: int = 0, device="cuda"):
    from ..experiments.wave import CONFIG, gen_data

    cfg = dict(CONFIG, Nx=Nx)
    if dist == "out":
        cfg["c"] = cfg["c"] * 0.5  # OOD: half wave speed
    data, dt_eff, dx = gen_data(cfg, n, seed, device)
    return data, _wave_pre(dt_eff, dx, cfg["c"]), cfg


def load_ns(dist: str = "in", n: int = 50, N: int = 128, x_slice: int = 2, seed: int = 0,
            device="cuda"):
    from ..experiments.ns import CONFIG, gen_data

    cfg = dict(CONFIG, N=N, x_slice=x_slice)
    if dist == "out":
        cfg["nu"] = cfg["nu"] * 10.0  # OOD: 10x viscosity
    data, dt_eff, dx = gen_data(cfg, n, seed, device)
    return data, _ns_pre(dt_eff, dx, cfg["nu"]), cfg


def load_mhd(dist: str = "in", n: int = 50, N: int = 64, seed: int = 0, device="cuda"):
    from ..experiments.mhd import CONFIG, gen_data

    cfg = dict(CONFIG, N=N)
    lb = ub = None
    if dist == "out":
        # OOD: a disjoint Orszag-Tang design box: field strength b above the
        # training range, density/pressure scale c below it (the training
        # box is (a, b, c) in [0.5, 1]^3). CFL-safe at the fixed dt: the fast
        # speed grows ~sqrt(1 + b^2/(4 pi rho)) <= 2.2 at (b, c) =
        # (1.5, 0.25), giving v dt / dx ~ 0.014 at N = 64.
        lb, ub = (0.5, 1.0, 0.25), (1.0, 1.5, 0.5)
    data, dt_eff, dx = gen_data(cfg, n, seed + (1000 if dist == "out" else 0), lb=lb, ub=ub,
                                device=device)
    return data, _mhd_pre(dt_eff, dx), cfg
