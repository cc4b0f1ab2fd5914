"""The tap table K1 and K8 take by value, against cppre's `_taps`.

`stencil_kernels._tap_table` lists a constant stencil's non-zero taps as the
kernels read them: int32 linear offsets for the strides of an [Nt, Nx, Ny]
field (K1, and the device table of K3, K9 and K10-K12) or of a slot of
K8's ring (whose strides the library gives), and float32 weights. Every residual the kernels compute adds
the taps in this order, so the table must be `cppre.ops.pallas.
stencil_kernels._taps`, tap for tap: the same order (itertools.product over
(t, x, y), zeros dropped), each offset the tap's (t, x, y) at those strides,
each weight the kernel's value rounded to float32. Exact comparisons: the
table is integer arithmetic and one rounding per weight.
"""

import numpy as np
import pytest

from cppre.ops.pallas.stencil_kernels import _taps as j_taps
from cppre.residuals.wave import PRE_Wave as JPRE_Wave
from cppre_torch.experiments import wave
from cppre_torch.ops.kernels import stencil_kernels as sk
from cppre_torch.residuals import PRE_Wave


def _random_kernel(k, seed, zeros=0.4):
    rng = np.random.default_rng(seed)
    kern = rng.standard_normal((k, k, k))
    kern[rng.random(kern.shape) < zeros] = 0.0
    return kern


def _kernels():
    wave = np.asarray(PRE_Wave(0.01, 2 / 63, 1.0).D.kernel)
    corner = np.array(wave, np.float32)
    corner[1, 0, 0] = corner[1, 2, 2] = 0.125          # a D_xy cross term
    return {"wave": wave, "k5": _random_kernel(5, 3), "corner": corner,
            "k7": _random_kernel(7, 4, zeros=0.7)}


# (Nx, Ny) of the strides: the wave field, a ragged field, and the shape of
# K8's ring slot at k = 3 (16 + 2 rows of 68 floats)
STRIDES = {"wave-field": (64, 64), "ragged-field": (13, 71), "slot-like": (18, 68)}


@pytest.mark.parametrize("strides", list(STRIDES))
@pytest.mark.parametrize("name", ["wave", "k5", "corner", "k7"])
def test_tap_table_is_cppre_taps(name, strides):
    kern = np.ascontiguousarray(_kernels()[name])
    k = kern.shape[0]
    nx, ny = STRIDES[strides]
    off, w = sk._tap_table(kern.tobytes(), k, kern.dtype.str, nx, ny)
    ref = j_taps(kern)
    assert off.dtype == np.int32 and w.dtype == np.float32
    assert off.size == w.size == len(ref) == np.count_nonzero(kern)
    np.testing.assert_array_equal(off, [it * nx * ny + ix * ny + iy
                                        for (it, ix, iy), _ in ref])
    np.testing.assert_array_equal(w, np.array([v for _, v in ref], np.float32))
    # the offsets rise in table order: the order is itertools.product's
    assert (np.diff(off) > 0).all()


def _wave_steps(disc):
    """(dt, dx) of the wave experiment's composite at time step dt x disc,
    as its run (disc 1) and its discretisation sweep (1, 2, 4) form it."""
    if disc is None:
        return 0.01, 2 / 63
    sim = wave._sim(wave.CONFIG, "cpu")
    return sim.dt * wave.CONFIG["t_slice"] * disc, sim.dx


@pytest.mark.parametrize("disc", [None, 1, 2, 4])
def test_wave_composite_is_cppre_kernel_with_seven_taps(disc):
    """The wave composite, the table K1 and K8 run on the wave path, is
    cppre's to the bit and has 7 taps, the count that goes by value, at the
    experiment's grid steps and at a unit-test grid (disc None)."""
    dt, dx = _wave_steps(disc)
    ours = np.asarray(PRE_Wave(dt, dx, 1.0).D.kernel)
    theirs = np.asarray(JPRE_Wave(dt, dx, 1.0).D.kernel)
    np.testing.assert_array_equal(ours.astype(np.float32), theirs.astype(np.float32))
    assert len(j_taps(theirs)) == 7
