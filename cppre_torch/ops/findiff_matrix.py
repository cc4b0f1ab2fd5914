"""Dense finite-difference operator matrices: the cross-check of the
convolution operators by plain matrix products (port of
`cppre.ops.findiff_matrix`; NumPy only, a copy of the JAX package's).

Interior points only: rows touching the boundary have their out-of-range
taps dropped, as a zero-padded 'same' convolution does.
"""

from __future__ import annotations

import numpy as np

__all__ = ["finite_difference_matrix_1d", "finite_difference_matrix_2d"]


def finite_difference_matrix_1d(n: int, stencil: np.ndarray) -> np.ndarray:
    """Dense [n, n] matrix applying a 1-D stencil with zero boundary extension."""
    stencil = np.asarray(stencil, dtype=np.float64)
    k = len(stencil)
    c = k // 2
    mat = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for s in range(k):
            j = i + s - c
            if 0 <= j < n:
                mat[i, j] += stencil[s]
    return mat


def finite_difference_matrix_2d(nx: int, ny: int, stencil: np.ndarray) -> np.ndarray:
    """Dense [(nx*ny), (nx*ny)] matrix applying a 2-D stencil (row-major
    flattening, zero boundary extension)."""
    stencil = np.asarray(stencil, dtype=np.float64)
    kx, ky = stencil.shape
    cx, cy = kx // 2, ky // 2
    n = nx * ny
    mat = np.zeros((n, n), dtype=np.float64)
    for ix in range(nx):
        for iy in range(ny):
            row = ix * ny + iy
            for sx in range(kx):
                for sy in range(ky):
                    jx, jy = ix + sx - cx, iy + sy - cy
                    if 0 <= jx < nx and 0 <= jy < ny:
                        mat[row, jx * ny + jy] += stencil[sx, sy]
    return mat
