"""The JOREK family of cppre_torch against cppre: `PRE_JOREK` (both
equations, `norms=True`, both y-axis conventions), K2's JOREK instance
(`jorek_residual_fused`), the JOREK joint-CP scores (K1) and the chunked
diff stats (K3), a non-affine major-radius grid, the load-time NaN scrub,
`synthetic_blobs` and `jorek.run` (the npz route) with the weights carried
over by `fno2d_from_jax` at T_in 10, step 10.

Inputs come from numpy seeds and go through both packages on the CPU; the
port's kernel wrappers take their plain versions there. cppre runs its
off-TPU (XLA) path, and its Pallas kernels in interpret mode in one case
each, at its own test shapes (`tests/test_pallas_kernels.py`: R =
linspace(1, 2, 16), fields [4, 3, 9, 16, 24]; the non-affine R =
linspace(1, 2, 12)**2 at [4, 3, 7, 12, 16]).

Tolerances:
* `PRE_JOREK`, and the port's residual against it: 1e-6 of max|residual|;
* the port's residual against cppre's fused JOREK residual: 1e-4 of max,
  cppre's own bound for that pair (`tests/test_pallas_kernels.py`). cppre's
  kernel rebuilds R as r0 + dr * (i + 1) from an iota, which rounds
  otherwise than the linspace grid `PRE_JOREK` multiplies by; the port's
  kernel reads the very R values `PRE_JOREK` uses;
* the diff stats against cppre's XLA route (non-affine R): 1e-5 of max,
  the residuals' 1e-6 grown by the diff being ~10x smaller than either
  residual;
* joint-CP scores: 2e-3 relative against cppre (the port takes the centred
  sum of squares, cppre the one-pass formula; ROADMAP, "Centred
  modulation");
* `jorek.run` from the same weights: qhat 1e-3 relative, joint coverage
  counts equal, marginal (per-cell) counts within 0.5% of the cells, as
  `tests/test_torch_mhd.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import jorek as jjorek
from cppre.models import FNO2d as JFNO2d
from cppre.ops.pallas import stencil_kernels as jsk
from cppre.residuals.jorek import PRE_JOREK as JPRE_JOREK
from cppre.utils import validate as jvalidate
from cppre_torch.experiments import jorek
from cppre_torch.models import FNO2d
from cppre_torch.ops import kernels as K
from cppre_torch.residuals import PRE_JOREK
from cppre_torch.utils import check_finite, check_shape, fno2d_from_jax, scrub_nan_sims

EQUATIONS = K.JOREK_EQUATIONS
R16 = np.linspace(1.0, 2.0, 16).astype(np.float32)


def _fields(seed, shape):
    """cppre's test fields: N(0, 1) + 2, so rho and T stay positive."""
    return (np.random.default_rng(seed).standard_normal(shape) + 2.0).astype(np.float32)


def _close(got, want, scale_rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rel * np.abs(want).max())


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("equation", EQUATIONS)
def test_pre_jorek_matches_cppre(equation, legacy):
    f = _fields(8, (4, 3, 9, 16, 24))
    ours = PRE_JOREK(R16, 0.01, 0.02, 0.02, legacy_y_axis=legacy, device="cpu")
    ref = JPRE_JOREK(R16, 0.01, 0.02, 0.02, legacy_y_axis=legacy)
    assert tuple(ours.R.shape) == (16, 1) and ours.R.device.type == "cpu"
    for boundary in (False, True):
        _close(ours.residual(torch.tensor(f), equation, boundary),
               ref.residual(jnp.asarray(f), equation, boundary), 1e-6)
    if equation == "continuity":
        _close(ours.residual_continuity(torch.tensor(f), norms=True),
               ref.residual_continuity(jnp.asarray(f), norms=True), 1e-6)
    with pytest.raises(ValueError):
        ours.residual(torch.tensor(f), "vorticity")


@pytest.mark.parametrize("equation,interpret", [(e, None) for e in EQUATIONS]
                         + [(e, True) for e in EQUATIONS])
def test_jorek_residual_kernel_matches_cppre(equation, interpret):
    f = _fields(8, (4, 3, 9, 16, 24))
    got = K.jorek_residual_fused(torch.tensor(f), R16, equation=equation)
    assert tuple(got.shape) == (4, 7, 14, 22)
    want = jsk.jorek_residual_fused(jnp.asarray(f), R16, equation=equation, interpret=interpret)
    _close(got, want, 1e-4)
    # the class it is the kernel of (boundary=False), at 1e-6
    _close(got, PRE_JOREK(R16, 1.0, 1.0, 1.0, device="cpu").residual(torch.tensor(f), equation),
           1e-6)
    np.testing.assert_array_equal(
        got.numpy(), K.jorek_residual_plain(torch.tensor(f), R16, equation=equation).numpy())


@pytest.mark.parametrize("equation,interpret", [(e, None) for e in EQUATIONS]
                         + [("continuity", True)])
def test_jorek_joint_cp_scores_match_cppre(equation, interpret):
    truth = _fields(8, (4, 3, 9, 16, 24))
    pred = truth + 0.05 * np.random.default_rng(9).standard_normal(truth.shape).astype(np.float32)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    got = K.jorek_joint_cp_scores_fused(tt, tp, R16, equation=equation, eps=1e-6)
    want = jsk.jorek_joint_cp_scores_fused(jnp.asarray(truth), jnp.asarray(pred), R16,
                                           equation=equation, eps=1e-6, interpret=interpret)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
    np.testing.assert_array_equal(
        got.numpy(),
        K.jorek_joint_cp_scores_plain(tt, tp, R16, equation=equation, eps=1e-6).numpy())
    # the chunked entry (t_block 3: chunks of 3, 3, 1 of the 7 interior
    # frames) gives the paired plain version's (diff, sum, sumsq), and the
    # diff is the difference of the two residuals
    chunked = K.jorek_joint_cp_diff_stats_chunked(tt, tp, R16, equation=equation, t_block=3)
    plain = K.jorek_joint_cp_diff_stats_chunked_plain(tt, tp, R16, equation=equation,
                                                      t_block=3)
    for a, b in zip(chunked, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        chunked[0].numpy(), (K.jorek_residual_fused(tt, R16, equation=equation)
                             - K.jorek_residual_fused(tp, R16, equation=equation)).numpy())
    jd, js, jq = jsk.jorek_joint_cp_diff_stats_chunked(jnp.asarray(truth), jnp.asarray(pred),
                                                       R16, equation=equation, t_block=3,
                                                       interpret=interpret)
    for a, b in zip(chunked, (jd, js, jq)):
        _close(a, b, 1e-4)


def test_non_affine_r_matches_cppre_xla_route():
    """A non-affine grid: cppre routes it to XLA (`PRE_JOREK`); the port's
    residual, scores and chunked diff stats take it as any other grid."""
    rng = np.random.default_rng(13)
    R = np.linspace(1.0, 2.0, 12).astype(np.float32) ** 2
    truth = _fields(13, (4, 3, 7, 12, 16))
    pred = truth + 0.05 * rng.standard_normal(truth.shape).astype(np.float32)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    for eq in EQUATIONS:
        _close(K.jorek_residual_fused(tt, R, equation=eq),
               jsk.jorek_residual_fused(jnp.asarray(truth), R, equation=eq), 1e-6)
    got = K.jorek_joint_cp_scores_fused(tt, tp, R)
    want = jsk.jorek_joint_cp_scores_fused(jnp.asarray(truth), jnp.asarray(pred), R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
    # the diff, sum and sum of squares within 1e-5 of their max: cppre's
    # XLA route forms the continuity residual through its convolution
    # operators, which round ~1e-7 of max|residual| otherwise than the
    # shifted slices of the kernel's math (held at 1e-6 above), and the
    # diff of two residuals 0.05 apart is ~10x smaller than either
    want = jsk.jorek_joint_cp_diff_stats_chunked(jnp.asarray(truth), jnp.asarray(pred), R)
    for a, b in zip(K.jorek_joint_cp_diff_stats_chunked(tt, tp, R), want):
        _close(a, b, 1e-5)
    # R as a tensor or as PRE_JOREK's [NR, 1] column gives the same cell
    np.testing.assert_array_equal(K.jorek_residual_fused(tt, torch.tensor(R)[:, None]).numpy(),
                                  K.jorek_residual_fused(tt, R).numpy())
    with pytest.raises(ValueError, match="rows"):
        K.jorek_residual_fused(tt, R[:-1])
    with pytest.raises(ValueError, match="equation"):
        K.jorek_residual_fused(tt, R, equation="vorticity")


def test_scrub_and_checks_match_cppre():
    f = np.random.default_rng(3).standard_normal((5, 3, 4, 4, 2)).astype(np.float32)
    f[1, 2, 0, 3, 1] = np.nan
    names = np.asarray(["a", "b", "c", "d", "e"])
    for args in ((f,), (f, names, ("d",))):
        clean, keep = scrub_nan_sims(*args)
        jclean, jkeep = jvalidate.scrub_nan_sims(*args)
        np.testing.assert_array_equal(keep, jkeep)
        np.testing.assert_array_equal(clean, jclean)
    assert scrub_nan_sims(f, names, ("d",))[1].tolist() == [True, False, True, False, True]
    assert jorek.scrub(f)[0].shape == (4, 3, 4, 4, 2)
    with pytest.raises(ValueError, match="f: 1/96 non-finite"):
        check_finite(f[1], "f")
    np.testing.assert_array_equal(check_finite(f[0]), f[0])
    check_shape(f, (None, 3, 4, 4, None))
    with pytest.raises(ValueError, match="shape"):
        check_shape(f, (5, 3, 4, 4))


def test_synthetic_blobs_match_cppre():
    ours = jorek.synthetic_blobs(3, NR=10, NZ=8, Nt=6, seed=4)
    ref = jjorek.synthetic_blobs(3, NR=10, NZ=8, Nt=6, seed=4)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert ours[3].shape == (3, 3, 10, 8, 6)
    assert jorek.CONFIG == jjorek.CONFIG


# T_in 10, step 10 (JOREK's), two rollout chunks, on a 12 x 12 grid of 30
# frames: 11 simulations in the npz, one of them NaN, 6 + 4 after the scrub
RUN = {"T_in": 10, "Step": 10, "T_out": 20, "n_train": 0, "n_cal": 6, "n_pred": 4,
       "Width_time": 4, "Modes": 3}


@pytest.fixture(scope="module")
def jorek_case(tmp_path_factory):
    """An npz in the reference's layout (raw units: the synthetic blobs
    times `field_norms`; simulation 3 NaN), and cppre's FNO2d weights at a
    fixed key carried into a port model by `fno2d_from_jax`."""
    R, Z, t, f = jorek.synthetic_blobs(11, NR=12, NZ=12, Nt=30, seed=5)
    f = f * np.asarray(jorek.CONFIG["field_norms"], np.float32)[None, :, None, None, None]
    f[3, 1, 4, 4, 7] = np.nan
    path = tmp_path_factory.mktemp("jorek") / "jorek.npz"
    np.savez(path, fields=f, R=R, Z=Z, t=t)
    jm = JFNO2d(T_in=10, step=10, modes1=3, modes2=3, num_vars=3, width_time=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 12, 12, 10))))
    model = fno2d_from_jax(params, FNO2d(10, 10, 3, 3, 3, 4, device="cpu"))
    return str(path), params, model


@pytest.mark.parametrize("mode", ["joint", "marginal"])
def test_jorek_run_matches_cppre(jorek_case, mode):
    """`jorek.run` end to end through the npz route (field norms, NaN scrub,
    normalisation, T_in 10 / step 10 rollout, K2's JOREK continuity
    residual, CP with the 1e-6 guard) from cppre's weights."""
    path, params, model = jorek_case
    ours = jorek.run(mode, path, config=RUN, params=model.state_dict(), verbose=False,
                     device="cpu", return_residuals=True)
    ref = jjorek.run(mode, path, config=RUN, params=params, verbose=False,
                     return_residuals=True)
    assert tuple(ours["res_pred"].shape) == np.asarray(ref["res_pred"]).shape == (4, 18, 10, 10)
    assert ours["pred_cal"].shape == (6, 3, 12, 12, 20)
    q, jq = np.asarray(ours["qhat"]), np.asarray(ref["qhat"])
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-3 * np.abs(jq).max())
    n = RUN["n_pred"] if mode == "joint" else ours["res_pred"].numel()
    slack = 0 if mode == "joint" else 0.005 * n
    for key in ("coverage_aer_pre", "coverage_pre", "coverage_aer_pre_holdout",
                "coverage_pre_holdout"):
        if ref[key] is None:
            assert ours[key] is None, key
            continue
        np.testing.assert_allclose(np.round(np.asarray(ours[key]) * n),
                                   np.round(np.asarray(ref[key]) * n), rtol=0, atol=slack,
                                   err_msg=key)


def test_jorek_training_smoke():
    """`jorek.run` on the synthetic route (32 x 32 x 50, as cppre makes it),
    cut to 2 + 4 + 2 designs, one step of one epoch at T_in 10 / step 10
    through the fused training apply (its plain version on the CPU)."""
    cfg = dict(RUN, n_train=2, n_cal=4, n_pred=2, Epochs=1, **{"Batch Size": 2})
    out = jorek.run("joint", config=cfg, verbose=False, device="cpu")
    assert len(out["train_losses"]) == 1 and np.isfinite(out["train_losses"]).all()
    assert out["pred_cal"].shape == (4, 3, 32, 32, 20) and np.isfinite(out["qhat"]).all()
