"""Finite-difference stencil tables (central differences, Taylor-expansion based).

NumPy-only twin of `cppre.ops.stencils`: the tables are plain data, shared
by the torch operators (`cppre_torch.ops.convops`) and held bit-equal to
the JAX package's in the tests.

Conventions
-----------
* 1-D stencils index the *leading* (time-like) axis of the data window; used
  as a cross-correlation kernel (`F.convNd` semantics) the entry at offset +1
  multiplies the sample at t+1, so [-1, 0, 1] computes u[t+1] - u[t-1]
  (un-normalised: no 1/(2*dt)).
* Stencils are *un-scaled*: grid-spacing factors are applied by the caller.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "stencil_1d",
    "stencil_2d",
    "stencil_time_space",
    "embed_kernel_3d",
]

_TABLE_1D = {
    (1, 2): [-1.0, 0.0, 1.0],
    (1, 4): [1 / 12, -2 / 3, 0.0, 2 / 3, -1 / 12],
    (1, 6): [-1 / 60, 3 / 20, -3 / 4, 0.0, 3 / 4, -3 / 20, 1 / 60],
    (2, 2): [1.0, -2.0, 1.0],
    (2, 4): [-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12],
    (2, 6): [1 / 90, -3 / 20, 3 / 2, -49 / 18, 3 / 2, -3 / 20, 1 / 90],
    # standard central 3rd/4th-derivative coefficients
    (3, 2): [-1 / 2, 1.0, 0.0, -1.0, 1 / 2],
    (3, 4): [1 / 8, -1.0, 13 / 8, 0.0, -13 / 8, 1.0, -1 / 8],
    (4, 2): [1.0, -4.0, 6.0, -4.0, 1.0],
}


def stencil_1d(deriv_order: int, taylor_order: int = 2) -> np.ndarray:
    """Central-difference 1-D stencil for d^n/dt^n; order 0 is [0, 1, 0]."""
    if deriv_order == 0:
        return np.array([0.0, 1.0, 0.0], dtype=np.float32)
    key = (deriv_order, taylor_order)
    if key not in _TABLE_1D:
        raise ValueError(f"Invalid stencil parameters: deriv_order={deriv_order}, "
                         f"taylor_order={taylor_order}")
    return np.asarray(_TABLE_1D[key], dtype=np.float32)


def stencil_2d(deriv_order: int, taylor_order: int = 2) -> np.ndarray:
    """2-D Laplacian-family stencils (deriv_order 2 only)."""
    if deriv_order != 2:
        raise ValueError(f"Invalid stencil parameters: 2-D stencils exist only "
                         f"for deriv_order=2, got {deriv_order}")
    if taylor_order == 2:
        return np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                        dtype=np.float32)
    if taylor_order in (4, 6):
        # separable sum of the 1-D second-derivative stencils
        s = stencil_1d(2, taylor_order)
        k = len(s)
        out = np.zeros((k, k), dtype=np.float32)
        out[k // 2, :] += s
        out[:, k // 2] += s
        return out
    raise ValueError(f"Invalid stencil parameters: taylor_order={taylor_order}")


def stencil_time_space(dims: int, deriv_order: int, taylor_order: int = 2) -> np.ndarray:
    """Square 2-D stencil on a [Nt, Nx] window: dims 1 puts the 1-D stencil in
    the centre column (derivative along the leading axis), dims 2 is the
    2-D Laplacian."""
    if dims == 1:
        s = stencil_1d(deriv_order, taylor_order)
        k = len(s)
        out = np.zeros((k, k), dtype=np.float32)
        out[:, k // 2] = s
        return out
    if dims == 2:
        return stencil_2d(deriv_order, taylor_order)
    raise ValueError(f"Invalid stencil parameters: dims={dims}")


def embed_kernel_3d(stencil: np.ndarray, axis: int, legacy_y_axis: bool = False) -> np.ndarray:
    """Embed a square 2-D stencil into the central plane of a cubic kernel
    ordered [t, x, y]: axis 0 spans (x, y), axis 1 spans (t, y), axis 2
    spans (t, x).

    The axis-1 ('y') stencil is transposed so that its variation lands on
    the y axis. ``legacy_y_axis=True`` keeps it untransposed, which turns
    d/dy into d/dt exactly as the upstream reference code does
    (`cppre.ops.stencils.embed_kernel_3d` documents the bug).
    """
    stencil = np.asarray(stencil, dtype=np.float32)
    k = stencil.shape[0]
    c = k // 2
    kernel = np.zeros((k, k, k), dtype=np.float32)
    if axis == 0:
        kernel[c, :, :] = stencil
    elif axis == 1:
        kernel[:, c, :] = stencil if legacy_y_axis else stencil.T
    elif axis == 2:
        kernel[:, :, c] = stencil
    else:
        raise ValueError("Invalid axis. Must be either 0, 1 or 2")
    return kernel
