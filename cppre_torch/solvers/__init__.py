"""PDE solvers that generate the experiments' training and calibration data."""

from .ns2d_spectral import NavierStokes2D, ns_solve, ns_solve_batch

__all__ = ["NavierStokes2D", "ns_solve", "ns_solve_batch"]
