"""PDE solvers that generate the experiments' training and calibration data."""

from .advection1d import Advection1D, advection_solve, advection_solve_batch
from .burgers1d import Burgers1D, burgers_solve_batch
from .mhd2d_constrained import mhd_solve, mhd_solve_batch
from .ns2d_spectral import NavierStokes2D, ns_solve, ns_solve_batch
from .solovev import gs_forcing, solovev_batch, solovev_psi
from .wave2d_spectral import Wave2D, wave_solve_batch

Wave_2D = Wave2D  # reference-name alias

__all__ = ["Advection1D", "Burgers1D", "NavierStokes2D", "Wave2D", "Wave_2D",
           "advection_solve", "advection_solve_batch", "burgers_solve_batch", "mhd_solve",
           "mhd_solve_batch", "ns_solve", "ns_solve_batch", "wave_solve_batch", "gs_forcing",
           "solovev_batch", "solovev_psi"]
