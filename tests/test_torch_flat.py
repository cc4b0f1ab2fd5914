"""The flat-layout joint-CP scores of cppre_torch (K10, K11, K12 and
`ns_/mhd_/wave_joint_cp_scores_flat`) against cppre on the CPU.

Inputs come from numpy seeds and go through both packages; the port's
wrappers take their plain versions on a CPU tensor, and cppre runs its
flat Pallas kernels in interpret mode. Tolerances:
* K10 over the whole flat window, the y-wrap columns included: 2e-6 of
  max|cppre| (the same float32 shift-adds, which cppre's interpret-mode
  kernel rounds otherwise than XLA's whole-array lowering: up to 1.5e-6 of
  max apart here; another reduction order for the sums over the batch);
* the flat scores: rtol 1e-5 (both take the one-pass modulation); a wave
  kernel wider than 3 goes to each package's fused scores, the port's with
  the centred modulation, and is held to cppre's own 2e-3 for that route;
* K11 then K12 against K10, and the flat math against the 3-D cell math on
  interior cells: bit for bit (the same operations on the same values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.ops.pallas import flat_kernels as jfk
from cppre.ops.pallas import stencil_kernels as jsk
from cppre.residuals.wave import PRE_Wave as JPRE_Wave
from cppre_torch.ops import kernels as K
from cppre_torch.ops.kernels import flat_kernels as fk
from cppre_torch.ops.kernels import stencil_kernels as sk

NS_ARGS = (0.01, 0.02, 0.02, 1e-3)
WAVE_KERNEL = np.asarray(JPRE_Wave(0.01, 0.02, c=1.0).D.kernel)
CORNER_KERNEL = np.zeros((3, 3, 3), np.float32)
CORNER_KERNEL[1, 1, 1] = -2.0
CORNER_KERNEL[1, 0, 0] = CORNER_KERNEL[1, 2, 2] = 1.0
CORNER_KERNEL[2, 1, 1] = 0.5


def _pair(seed, shape, rho=False):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal(shape).astype(np.float32)
    if rho:
        t[:, 0] += 3.0                  # the momentum residual divides by rho
    p = (t + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return t, p


def _case(name):
    """(truth, prediction) [BS, nvar, nt, nx, ny], the port's cell, cppre's
    flat math for one [nvar, nt, L] block, and the window's margin."""
    if name in ("ns", "ns-odd-ny"):
        t, p = _pair(11, (6, 3, 8, 16, 24)) if name == "ns" else _pair(12, (5, 3, 7, 11, 37))
        nt, nx, ny = t.shape[2:]
        return (t, p, sk._ns_cell(*NS_ARGS),
                lambda f: jfk._ns_momentum_flat(f, nt, ny, (nx - 2) * ny, *NS_ARGS), ny)
    if name.startswith("mhd"):
        t, p = _pair(13, (5, 6, 8, 12, 16), rho=True)
        nt, nx, ny = t.shape[2:]
        eq = name.split("-")[1]
        return t, p, sk._mhd_cell(eq), lambda f: jfk._mhd_flat(eq, f, nt, ny, (nx - 2) * ny), ny
    kern = WAVE_KERNEL if name == "wave" else CORNER_KERNEL
    t, p = _pair(14 if name == "wave" else 21, (6, 1, 8, 12, 16))
    nt, nx, ny = t.shape[2:]
    off = jfk._composite_off(kern, ny)
    assert off == fk._composite_off(kern, ny) == (ny if name == "wave" else ny + 1)
    lo = nx * ny - 2 * off
    return (t, p, sk._taps_cell(kern),
            lambda f: jfk._composite_flat(kern, f, nt, ny, lo, off), off)


def _flat(a):
    return a.reshape(a.shape[:3] + (-1,))


@pytest.mark.parametrize("name", ["ns", "ns-odd-ny", "mhd-induction", "wave", "wave-corner"])
def test_flat_paired_kernel_matches_cppre(name):
    """K10's |d|, sum and sumsq over the whole window, y-wrap columns
    included, also where Ny is odd (the card tests' ragged rows); K11 then
    K12 give K10's bits."""
    t, p, res, jmath, off = _case(name)
    ny = t.shape[-1]
    tt, tp = torch.tensor(_flat(t)), torch.tensor(_flat(p))
    got = fk._flat_paired_absdiff_stats(tt, tp, res, ny, off)
    want = jfk._flat_paired_absdiff_stats(jnp.asarray(_flat(t)), jnp.asarray(_flat(p)), jmath,
                                          t.shape[2], True)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-6 * np.abs(b).max())
    two = fk._flat_absdiff_stats_from_res(tp, fk._flat_residual_kernel(tt, res, ny, off), res,
                                          ny, off)
    assert all(torch.equal(a, b) for a, b in zip(two, got))


@pytest.mark.parametrize("equation", K.MHD_EQUATIONS)
def test_flat_mhd_scores_match_cppre(equation):
    t, p = _pair(13, (5, 6, 8, 12, 16), rho=True)
    got = K.mhd_joint_cp_scores_flat(torch.tensor(t), torch.tensor(p), equation)
    want = jfk.mhd_joint_cp_scores_flat(jnp.asarray(t), jnp.asarray(p), equation,
                                        interpret=True)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert torch.equal(got, K.mhd_joint_cp_scores_flat_plain(torch.tensor(t), torch.tensor(p),
                                                             equation))


def test_flat_ns_scores_match_cppre():
    t, p = _pair(11, (6, 3, 8, 16, 24))
    got = K.ns_joint_cp_scores_flat(torch.tensor(t), torch.tensor(p), *NS_ARGS)
    want = jfk.ns_joint_cp_scores_flat(jnp.asarray(t), jnp.asarray(p), *NS_ARGS, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert torch.equal(got, K.ns_joint_cp_scores_flat_plain(torch.tensor(t), torch.tensor(p),
                                                            *NS_ARGS))


@pytest.mark.parametrize("name", ["composite", "corner", "wide"])
def test_flat_wave_scores_match_cppre(name):
    """The composite kernel, a kernel with corner taps (window margin
    ny + 1), and a 5x5x5 kernel, which both packages route to their fused
    scores (cppre `tests/test_pallas_kernels.py:327-375`)."""
    if name == "wide":
        kern = np.zeros((5, 5, 5), np.float32)
        c4 = np.array([-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12], np.float32)
        kern[:, 2, 2] += c4
        kern[2, :, 2] -= 0.5 * c4
        kern[2, 2, :] -= 0.5 * c4
        t, p = _pair(23, (4, 10, 14, 18))
    else:
        kern = WAVE_KERNEL if name == "composite" else CORNER_KERNEL
        t, p = _pair(14 if name == "composite" else 21, (6, 8, 12, 16))
    got = K.wave_joint_cp_scores_flat(torch.tensor(t), torch.tensor(p), kern)
    want = np.asarray(jfk.wave_joint_cp_scores_flat(jnp.asarray(t), jnp.asarray(p), kern,
                                                    interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3 if name == "wide" else 1e-5)
    plain = K.wave_joint_cp_scores_flat_plain(torch.tensor(t), torch.tensor(p), kern)
    assert torch.equal(got, plain)
    if name == "wide":
        assert torch.equal(got, K.wave_joint_cp_scores_fused(torch.tensor(t), torch.tensor(p),
                                                             kern))


@pytest.mark.parametrize("name", ["ns", "mhd-continuity", "mhd-momentum", "mhd-energy",
                                  "mhd-induction", "mhd-gauss", "wave"])
def test_flat_math_is_the_cell_math(name):
    """On the interior cells of the flat window (y-wrap columns dropped) the
    flat residual is the 3-D residual: the port's bit for bit, cppre's flat
    math within 1e-6 of max|cppre's 3-D math|."""
    t, p, res, jmath, off = _case(name)
    bs, nvar, nt, nx, ny = t.shape
    flat = fk._flat_residual_kernel(torch.tensor(_flat(t)), res, ny, off)
    grid = res.math(torch.tensor(t))
    inner = flat.reshape(bs, nt - 2, nx - 2, ny)[..., 1:-1]
    assert torch.equal(inner, grid)
    if name == "wave":
        jgrid = np.asarray(jsk._valid_shift_add(jnp.asarray(t[0, 0]), jsk._taps(WAVE_KERNEL),
                                                (nt - 2, nx - 2, ny - 2)))
    elif name == "ns":
        jgrid = np.asarray(jsk._ns_momentum_math(*jnp.asarray(t[0, :3]), nt, nx, ny,
                                                 *NS_ARGS[:3], NS_ARGS[3]))
    else:
        jgrid = np.asarray(jsk._mhd_math(name.split("-")[1], jnp.asarray(t[0]), nt, nx, ny))
    jflat = np.asarray(jmath(jnp.asarray(_flat(t)[0]))).reshape(nt - 2, nx - 2, ny)[..., 1:-1]
    np.testing.assert_allclose(jflat, jgrid, rtol=0, atol=1e-6 * np.abs(jgrid).max())


def test_flat_routing_and_checks():
    """K10 for the NS, wave and MHD shapes (where the card timed it faster
    than K11 then K12); the window and the shapes are checked before any
    route is taken."""
    assert K.flat_routing_decision((100, 3, 21, 100, 100)) == "paired"
    assert K.flat_routing_decision((1000, 1, 20, 64, 64)) == "paired"
    assert K.flat_routing_decision((100, 6, 20, 128, 128)) == "paired"
    t, p = _pair(1, (2, 3, 5, 8, 9))
    with pytest.raises(ValueError):
        K.mhd_joint_cp_scores_flat(torch.tensor(t), torch.tensor(p))      # needs 6 fields
    with pytest.raises(ValueError):
        fk._flat_residual_kernel(torch.tensor(_flat(t)), sk._ns_cell(*NS_ARGS), 9, 11)
