"""cppre_torch CP core, experiment engine, normalizers and rollout vs cppre.

Inputs are made with numpy from a seed and handed to both packages.
`calibrate` must select exactly the same calibration score (equality);
the std-based functions agree to 1e-6 relative (float32 reductions in
another order); masks and coverages are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cppre.cp.inductive as jcp
import cppre.experiments.pipeline as jpipe
import cppre.train.normalizers as jnorm
from cppre.train.rollout import autoregressive_rollout as j_rollout
from cppre.train.rollout import validation_AR as j_validation_AR
from cppre_torch.cp import inductive as cp
from cppre_torch.experiments import pipeline
from cppre_torch.train import normalizers as norm
from cppre_torch.train.rollout import autoregressive_rollout, validation_AR
from cppre_torch.utils import normalizer_from_jax


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n", [7, 20, 100, 333])
@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.25, 0.5, 0.9])
def test_calibrate_selects_the_same_score(n, alpha):
    assert cp.cp_quantile_level(n, alpha) == jcp.cp_quantile_level(n, alpha)
    joint = _rng(n).standard_normal(n).astype(np.float32)
    assert float(cp.calibrate(torch.tensor(joint), n, alpha)) == float(
        jcp.calibrate(jnp.asarray(joint), n, alpha))
    marginal = _rng(n + 1).standard_normal((n, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(cp.calibrate(torch.tensor(marginal), None, alpha).numpy(),
                                  np.asarray(jcp.calibrate(jnp.asarray(marginal), None, alpha)))


def test_cp_functions_match_cppre():
    r = _rng(1)
    a = r.standard_normal((12, 5, 6)).astype(np.float32)
    b = a + 0.3 * r.standard_normal(a.shape).astype(np.float32)
    ta, tb, ja, jb = torch.tensor(a), torch.tensor(b), jnp.asarray(a), jnp.asarray(b)
    mod = cp.modulation_func(ta, tb)
    np.testing.assert_allclose(mod.numpy(), np.asarray(jcp.modulation_func(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(cp.modulation_func(ta).numpy(),
                               np.asarray(jcp.modulation_func(ja)), rtol=1e-6)
    jm = jcp.modulation_func(ja, jb)
    np.testing.assert_allclose(cp.ncf_metric_joint(ta, tb, torch.tensor(np.asarray(jm))).numpy(),
                               np.asarray(jcp.ncf_metric_joint(ja, jb, jm)), rtol=1e-6)
    lo, hi = -0.5 * np.ones((5, 6), np.float32), 0.8 * np.ones((5, 6), np.float32)
    tsets, jsets = (torch.tensor(lo), torch.tensor(hi)), (jnp.asarray(lo), jnp.asarray(hi))
    assert cp.emp_cov(tsets, ta) == jcp.emp_cov(jsets, ja)
    assert cp.emp_cov_joint(tsets, 0.1 * ta) == jcp.emp_cov_joint(jsets, 0.1 * ja)
    np.testing.assert_array_equal(cp.filter_sims_joint(tsets, 0.2 * ta).numpy(),
                                  np.asarray(jcp.filter_sims_joint(jsets, 0.2 * ja)))
    for within in (False, True):
        for thr in (0.3, 0.5):
            np.testing.assert_array_equal(
                cp.filter_sims_within_bounds(lo, hi, ta, thr, within).numpy(),
                np.asarray(jcp.filter_sims_within_bounds(lo, hi, ja, thr, within)))


@pytest.mark.parametrize("mode", ["aer+pre", "pre"])
@pytest.mark.parametrize("holdout", [False, True])
def test_joint_cp_matches_cppre(mode, holdout):
    r = _rng(2)
    res_out = r.standard_normal((40, 4, 5)).astype(np.float32)
    res_pred = res_out + 0.2 * r.standard_normal(res_out.shape).astype(np.float32)
    new_pred = r.standard_normal((30, 4, 5)).astype(np.float32)
    new_out = new_pred + 0.2 * r.standard_normal(new_pred.shape).astype(np.float32)
    t = lambda a: torch.tensor(a)
    ours = pipeline.joint_cp(t(res_out), t(res_pred), t(new_pred), t(new_out), mode=mode,
                             eps=1e-6, holdout_modulation=holdout)
    ref = jpipe.joint_cp(res_out, res_pred, new_pred, new_out, mode=mode, eps=1e-6,
                         holdout_modulation=holdout)
    np.testing.assert_allclose(float(ours["qhat"]), float(ref["qhat"]), rtol=1e-6)
    np.testing.assert_allclose(ours["modulation"].numpy(), np.asarray(ref["modulation"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(ours["alphas"], ref["alphas"])
    # equal counts of covered samples (the two means may round differently)
    np.testing.assert_array_equal(np.round(ours["coverage"] * 30), np.round(ref["coverage"] * 30))
    np.testing.assert_array_equal(ours["filter_mask"].numpy(), np.asarray(ref["filter_mask"]))


@pytest.mark.parametrize("mode", ["aer+pre", "pre"])
def test_marginal_cp_matches_cppre(mode):
    r = _rng(3)
    res_out = r.standard_normal((30, 4, 5)).astype(np.float32)
    res_pred = res_out + 0.2 * r.standard_normal(res_out.shape).astype(np.float32)
    new_pred = r.standard_normal((20, 4, 5)).astype(np.float32)
    new_out = new_pred + 0.2 * r.standard_normal(new_pred.shape).astype(np.float32)
    t = lambda a: torch.tensor(a)
    ours = pipeline.marginal_cp(t(res_out), t(res_pred), t(new_pred), t(new_out), mode=mode)
    ref = jpipe.marginal_cp(res_out, res_pred, new_pred, new_out, mode=mode)
    np.testing.assert_array_equal(ours["qhat"].numpy(), np.asarray(ref["qhat"]))
    np.testing.assert_array_equal(np.round(ours["coverage"] * 400),
                                  np.round(ref["coverage"] * 400))    # covered cells
    if mode == "pre":
        np.testing.assert_array_equal(ours["filter_mask"].numpy(),
                                      np.asarray(ref["filter_mask"]))


@pytest.mark.parametrize("cls", ["MinMaxNormalizer", "RangeNormalizer", "GaussianNormalizer",
                                 "Identity"])
def test_normalizers_match_cppre(cls):
    r = _rng(4)
    x = (3.0 * r.standard_normal((10, 2, 6, 5, 3)) + 1.5).astype(np.float32)
    ours, ref = getattr(norm, cls)(torch.tensor(x)), getattr(jnorm, cls)(jnp.asarray(x))
    # mean and std are float32 reductions over 900 values, summed in another order
    np.testing.assert_allclose(ours.a.numpy(), np.asarray(ref.a), rtol=1e-5)
    np.testing.assert_allclose(ours.b.numpy(), np.asarray(ref.b), rtol=1e-5, atol=1e-7)
    enc = ours.encode(torch.tensor(x))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref.encode(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.decode(enc).numpy(), x, rtol=1e-5, atol=1e-5)
    # carried across: the port's normalizer from cppre's coefficients
    carried = normalizer_from_jax(ref, device="cpu")
    np.testing.assert_array_equal(carried.a.numpy(), np.asarray(ref.a))
    np.testing.assert_array_equal(carried.encode(torch.tensor(x)).numpy(),
                                  np.asarray(ref.encode(jnp.asarray(x))))


@pytest.mark.parametrize("step,t_out", [(1, 4), (2, 6), (3, 3)])
def test_rollout_matches_cppre(step, t_out):
    r = _rng(5)
    w = r.standard_normal((3, step)).astype(np.float32) * 0.5
    xx = r.standard_normal((4, 2, 3)).astype(np.float32)
    t_fn = lambda x: torch.tanh(x @ torch.tensor(w))
    j_fn = lambda x: jnp.tanh(x @ jnp.asarray(w))
    ours = autoregressive_rollout(t_fn, torch.tensor(xx), step, t_out)
    ref = j_rollout(j_fn, jnp.asarray(xx), step, t_out)
    assert ours.shape == ref.shape == (4, 2, t_out)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    u = r.standard_normal((4, 2, t_out)).astype(np.float32)
    _, mse, mae = validation_AR(t_fn, torch.tensor(xx), torch.tensor(u), step, t_out)
    _, jmse, jmae = j_validation_AR(j_fn, jnp.asarray(xx), jnp.asarray(u), step, t_out)
    np.testing.assert_allclose([float(mse), float(mae)], [float(jmse), float(jmae)], rtol=1e-5)
    with pytest.raises(ValueError):
        autoregressive_rollout(t_fn, torch.tensor(xx), 4, 6)
