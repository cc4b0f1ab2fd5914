"""Set propagation in the port (`cppre_torch.sets`) against cppre.

Inputs are made with numpy from seeds and go through both packages on the
CPU.

Tolerances:
* `Zonotope`, `interval_fft`, `inverse_interval_fft`, `complex_prod`,
  `real_interval`: bit for bit (the same float64 numpy code);
* `propagate_through_deconvolution` on the same float32 inputs: the radii
  within 1e-6 of max|radius| (no FFT: the lag kernel, its float32 phase
  angle in cppre's order of operations, and one product); the centres and
  the bounds within 1e-6 of max|bound| at moderate multipliers;
* `set_PRE` and `set_pre_batched`: within 1e-5 of max|bound|. Both run the
  padded trajectory through a float32 FFT and then multiply by
  1/(K_hat + eps), whose largest value is 1/(dt^2 k) ~ 98 for the SHO
  kernel at the default dt: two FFT libraries' float32 roundings (~1e-7 of
  the spectrum) come out 2-5e-6 of max|bound| apart at every length tried
  (N = 40 to 1000); cppre's own jitted and eager `set_pre_batched` lie
  ~5e-7 of max|bound| apart, and its float32 bounds 1e-4 from its float64
  ones (its own test's bound);
* containment: every padded input trajectory lies inside the port's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre import sets as J
from cppre_torch import sets as T


def _intervals(seed, n=8):
    r = np.random.default_rng(seed)
    c = r.standard_normal(n)
    rad = np.abs(r.standard_normal(n)) * 0.3
    return c, rad, r.standard_normal(n) + 1j * r.standard_normal(n)


def _same_zonotope(a, b):
    np.testing.assert_array_equal(a.center, b.center)
    np.testing.assert_array_equal(a.generators, b.generators)
    assert a.dim == b.dim


def test_zonotope_bit_for_bit():
    r = np.random.default_rng(0)
    c, g, m, p = (r.standard_normal(s) for s in (2, (2, 3), (2, 2), 2))
    many = r.standard_normal((2, 14))

    def use(mod):
        z = mod.Zonotope(c, g)
        w = mod.Zonotope.from_interval(-0.3, 1.2)
        zs = [z + w, 2.5 * z, z * -1.5, z.linear_map(m), mod.Zonotope(c, g[:, 0])]
        arrays = [*z.interval_hull(), *w.interval_hull(), z.vertices(),
                  mod.Zonotope(c, many).vertices()]
        facts = (z.contains(p), z.contains(c), mod.Zonotope(c, np.eye(2)).contains(c + 1.5))
        return zs, arrays, facts

    (zs, arrays, facts), (jzs, jarrays, jfacts) = use(T), use(J)
    for a, b in zip(zs, jzs):
        _same_zonotope(a, b)
    for a, b in zip(arrays, jarrays):
        np.testing.assert_array_equal(a, b)
    assert facts == jfacts and facts[1] and not facts[2]


def test_interval_fft_pipeline_bit_for_bit():
    c, rad, C = _intervals(2)
    ivs = list(zip(c - rad, c + rad))
    zs_t, zs_j = T.interval_fft(ivs), J.interval_fft(ivs)
    for a, b in zip(zs_t, zs_j):
        _same_zonotope(a, b)
    prod_t = [T.complex_prod(z, C[h]) for h, z in enumerate(zs_t)]
    prod_j = [J.complex_prod(z, C[h]) for h, z in enumerate(zs_j)]
    for a, b in zip(prod_t, prod_j):
        _same_zonotope(a, b)
    back_t, back_j = T.inverse_interval_fft(prod_t), J.inverse_interval_fft(prod_j)
    for a, b in zip(back_t, back_j):
        _same_zonotope(a, b)
        assert T.real_interval(a) == J.real_interval(b)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_propagate_through_deconvolution_matches_cppre(batch):
    r = np.random.default_rng(3)
    n = 40
    c = r.standard_normal(batch + (n,)).astype(np.float32)
    rad = np.abs(r.standard_normal(batch + (n,))).astype(np.float32)
    C = (r.standard_normal(n) + 1j * r.standard_normal(n))
    oc, orad = T.propagate_through_deconvolution(c, rad, C, device="cpu")
    jc, jr = (np.asarray(v) for v in jax.jit(J.propagate_through_deconvolution)(c, rad, C))
    assert oc.dtype == orad.dtype == torch.float32 and oc.shape == batch + (n,)
    np.testing.assert_allclose(orad.numpy(), jr, rtol=0, atol=1e-6 * np.abs(jr).max())
    scale = np.abs(np.stack([jc - jr, jc + jr])).max()
    np.testing.assert_allclose(oc.numpy(), jc, rtol=0, atol=1e-6 * scale)
    # the dense map is the object pipeline (float64) at float32 rounding
    if not batch:
        zs = [T.complex_prod(z, C[h]) for h, z in enumerate(T.interval_fft(
            list(zip(c.astype(np.float64) - rad, c.astype(np.float64) + rad))))]
        obj = np.array([T.real_interval(z) for z in T.inverse_interval_fft(zs)])
        got = np.stack([(oc - orad).numpy(), (oc + orad).numpy()], axis=-1)
        np.testing.assert_allclose(got, obj, rtol=0, atol=1e-5 * np.abs(obj).max())


def _trajectories(seed, b, nt):
    r = np.random.default_rng(seed)
    t = np.arange(nt) * 0.1010101
    x = (np.cos(t * r.uniform(0.8, 1.2, (b, 1))) * r.uniform(0.5, 1.5, (b, 1))
         + 0.01 * r.standard_normal((b, nt)))
    return x.astype(np.float32)


def _bounds_close(ours, ref, rel):
    lo, up = (np.asarray(v) for v in ours)
    jlo, jup = (np.asarray(v) for v in ref)
    assert lo.shape == jlo.shape
    scale = max(np.abs(jlo).max(), np.abs(jup).max())
    np.testing.assert_allclose(lo, jlo, rtol=0, atol=rel * scale)
    np.testing.assert_allclose(up, jup, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("nt", [38, 98])
def test_set_pre_batched_matches_cppre_and_contains(nt):
    x = _trajectories(4, 6, nt)
    lo, up = T.set_pre_batched(x, device="cpu")
    assert lo.shape == (6, nt + 2) and lo.dtype == torch.float32
    _bounds_close((lo, up), jax.jit(J.set_pre_batched)(jnp.asarray(x)), 1e-5)
    padded = np.pad(x, ((0, 0), (1, 1)))
    assert (lo.numpy() <= padded).all() and (up.numpy() >= padded).all()
    # one trajectory, [Nt] in, is a batch of one (a batch of 6 takes other
    # FFT and product blockings: 1e-6)
    _bounds_close(T.set_pre_batched(x[0], device="cpu"), (lo[:1], up[:1]), 1e-6)


def test_set_PRE_matches_cppre_and_the_batched_row():
    x = _trajectories(5, 1, 60)[0]
    ours = np.array(T.set_PRE(x, device="cpu"))
    ref = np.array(J.set_PRE(x))
    assert ours.shape == ref.shape == (62, 2) and ours.dtype == np.float32
    _bounds_close((ours[:, 0], ours[:, 1]), (ref[:, 0], ref[:, 1]), 1e-5)
    padded = np.pad(x, 1)
    assert (ours[:, 0] <= padded).all() and (ours[:, 1] >= padded).all()
    # the float64 build against the float32 batch: cppre's own test bound
    lo, up = T.set_pre_batched(x, device="cpu")
    _bounds_close((ours[:, 0], ours[:, 1]), (lo[0], up[0]), 2e-4)


def test_sets_all_matches_cppre():
    assert T.__all__ == J.__all__
