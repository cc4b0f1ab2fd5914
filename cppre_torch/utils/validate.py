"""Data validation at load: NaN and shape guards (port of `cppre.utils.validate`).

The reference scrubs NaNs by hand and keeps a hand-maintained list of bad
runs (`Joint/JOREK_residuals_CP.py:131-142`); these helpers make that a
reusable, asserted step. They work on numpy arrays, before any data goes to
the card.
"""

from __future__ import annotations

import numpy as np

__all__ = ["check_finite", "check_shape", "scrub_nan_sims"]


def check_finite(x, name: str = "array"):
    """Raise with a count/location summary if x has NaNs or infs."""
    x = np.asarray(x)
    bad = ~np.isfinite(x)
    if bad.any():
        idx = np.argwhere(bad)[:5]
        raise ValueError(f"{name}: {int(bad.sum())}/{x.size} non-finite values "
                         f"(first at indices {idx.tolist()})")
    return x


def check_shape(x, expected, name: str = "array"):
    """Assert shape; `None` entries are wildcards."""
    x = np.asarray(x)
    if len(x.shape) != len(expected) or any(
            e is not None and s != e for s, e in zip(x.shape, expected)):
        raise ValueError(f"{name}: shape {x.shape} != expected {tuple(expected)}")
    return x


def scrub_nan_sims(fields, names=None, bad_list=()):
    """Drop simulations (leading axis) containing NaNs or named in the
    curated bad list; returns (clean_fields, keep_mask)."""
    fields = np.asarray(fields)
    ok = ~np.isnan(fields).any(axis=tuple(range(1, fields.ndim)))
    if names is not None and bad_list:
        ok &= ~np.isin(np.asarray(names), list(bad_list))
    return fields[ok], ok
