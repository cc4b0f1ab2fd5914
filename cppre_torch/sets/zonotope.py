"""Zonotopes: centre + generator columns (port of `cppre.sets.zonotope`).

A small float64 numpy object, as in `cppre`, bit for bit: Minkowski sum,
linear map, scalar scaling, interval hull, containment (an LP through
`scipy.optimize.linprog`, the interval hull without scipy) and vertex
enumeration (`scipy.spatial.ConvexHull`). The propagation path never
builds these objects (`interval_fft.propagate_through_deconvolution`).
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["Zonotope"]


class Zonotope:
    def __init__(self, center, generators):
        self.center = np.asarray(center, dtype=float)
        gens = np.asarray(generators, dtype=float)
        if gens.ndim == 1:
            gens = gens[:, None]
        self.generators = gens  # [dim, n_gen]
        self.dim = self.center.shape[0]

    @classmethod
    def from_interval(cls, lo: float, hi: float):
        """A real interval as a 2-D (re, im) zonotope on the real axis."""
        center = np.array([(lo + hi) / 2.0, 0.0])
        gen = np.array([[(hi - lo) / 2.0], [0.0]])
        return cls(center, gen)

    # -- operations --------------------------------------------------------
    def __add__(self, other: "Zonotope") -> "Zonotope":
        """Minkowski sum: add centres, concatenate generators."""
        return Zonotope(self.center + other.center,
                        np.hstack((self.generators, other.generators)))

    def __mul__(self, scalar: float) -> "Zonotope":
        return Zonotope(scalar * self.center, scalar * self.generators)

    __rmul__ = __mul__

    def linear_map(self, matrix) -> "Zonotope":
        m = np.asarray(matrix, dtype=float)
        return Zonotope(m @ self.center, m @ self.generators)

    # -- queries ------------------------------------------------------------
    def interval_hull(self):
        """Per-dimension bounds: centre +- sum(|generators|)."""
        rad = np.abs(self.generators).sum(axis=1)
        return self.center - rad, self.center + rad

    def contains(self, point, tol: float = 1e-9) -> bool:
        """Exact containment by LP feasibility (||xi||_inf <= 1 s.t.
        G xi = p - c); the interval hull where scipy's linprog is missing."""
        p = np.asarray(point, dtype=float) - self.center
        G = self.generators
        try:
            from scipy.optimize import linprog

            n = G.shape[1]
            # minimise 0 s.t. G xi = p, -1 <= xi <= 1
            res = linprog(np.zeros(n), A_eq=G, b_eq=p,
                          bounds=[(-1, 1)] * n, method="highs")
            return bool(res.success)
        except ImportError:
            lo, hi = self.interval_hull()
            return bool(np.all(point >= lo - tol) and np.all(point <= hi + tol))

    def vertices(self, max_generators: int = 12):
        """Vertex enumeration by sign combinations and a convex hull; random
        sign samples past `max_generators`."""
        n = self.generators.shape[1]
        if n > max_generators:
            rng = np.random.RandomState(0)
            coeffs = np.sign(rng.uniform(-1, 1, (1024, n)))
        else:
            coeffs = np.array(list(itertools.product((-1.0, 1.0), repeat=n)))
        pts = self.center + coeffs @ self.generators.T
        if self.dim <= 1 or n <= 1:
            return pts
        try:
            from scipy.spatial import ConvexHull

            hull = ConvexHull(pts)
            return pts[hull.vertices]
        except Exception:
            return pts
