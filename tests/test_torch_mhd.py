"""The MHD family of cppre_torch against cppre: `PRE_MHD` (five equations,
both y-axis conventions), K2's MHD instances (`mhd_residual_fused`), K1's
MHD-induction instance and K9 (`mhd_induction_joint_cp_scores_fused` and
`ns_joint_cp_scores_fused` with `single_pass`), the constrained-transport
solver, `gen_data`, `mhd.run` and the carry-over of the MHD model's weights.

Inputs come from numpy seeds and go through both packages on the CPU; the
port's kernel wrappers take their plain versions there. cppre runs its
off-TPU path, and its Pallas kernels in interpret mode in one case each.

Tolerances:
* `PRE_MHD`: 1e-6 of max|residual|;
* K2 against cppre's kernel: 2e-6 absolute (`tests/test_pallas_kernels.py`);
* joint-CP scores: 2e-3 relative against cppre, and the single-pass route
  within 1e-6 relative of the two-pass one (`tests/test_pallas_kernels.py`);
* the solver: fields within 1e-5 of max|field| after 100 steps; `err`
  (max |div B| dx) is float32 rounding noise of a divergence-free field, so
  it is held to an absolute bound, not to cppre's value;
* `mhd.run` from the same weights: qhat 1e-3 relative, joint coverage counts
  equal, marginal (per-cell) counts within 0.5% of the cells. The weights
  are cppre's initialisation from a fixed key (see `tests/test_torch_wave.py`
  on the conditioning of the in-sample PRE-only estimator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import mhd as jmhd
from cppre.models import FNO2d as JFNO2d
from cppre.ops.pallas import stencil_kernels as jsk
from cppre.residuals.mhd import PRE_MHD as JPRE_MHD
from cppre.solvers.mhd2d_constrained import mhd_solve as jmhd_solve
from cppre.solvers.mhd2d_constrained import mhd_solve_batch as jmhd_solve_batch
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import mhd
from cppre_torch.models import FNO2d
from cppre_torch.ops import kernels as K
from cppre_torch.residuals import PRE_MHD
from cppre_torch.solvers import mhd_solve, mhd_solve_batch
from cppre_torch.utils import fno2d_from_jax

EQUATIONS = PRE_MHD.EQUATIONS


def _mhd_fields(seed, shape):
    """Random MHD-like fields [BS, 6, Nt, Nx, Ny] with a density bounded
    away from 0 (the momentum residual divides by it)."""
    f = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    f[:, 0] = 1.5 + 0.3 * np.tanh(f[:, 0])
    return f


def _close(got, want, scale_rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rel * np.abs(want).max())


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("equation", EQUATIONS)
def test_pre_mhd_matches_cppre(equation, legacy):
    f = _mhd_fields(0, (2, 6, 6, 11, 9))
    ours, ref = PRE_MHD(0.01, 0.02, 0.03, legacy), JPRE_MHD(0.01, 0.02, 0.03, legacy)
    assert ours.EQUATIONS == ref.EQUATIONS
    for boundary in (False, True):
        _close(ours.residual(torch.tensor(f), equation, boundary),
               ref.residual(jnp.asarray(f), equation, boundary), 1e-6)
    with pytest.raises(ValueError):
        ours.residual(torch.tensor(f), "vorticity")


@pytest.mark.parametrize("equation,interpret", [(e, None) for e in EQUATIONS]
                         + [("induction", True)])
def test_mhd_residual_kernel_matches_cppre(equation, interpret):
    f = _mhd_fields(1, (3, 6, 7, 12, 10))
    got = K.mhd_residual_fused(torch.tensor(f), equation)
    want = jsk.mhd_residual_fused(jnp.asarray(f), equation, interpret=interpret)
    assert tuple(got.shape) == (3, 5, 10, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    # the class it is the kernel of (boundary=False)
    _close(got, PRE_MHD(1.0, 1.0, 1.0).residual(torch.tensor(f), equation), 1e-6)
    if equation == "induction":
        np.testing.assert_array_equal(K.mhd_induction_residual_fused(torch.tensor(f)).numpy(),
                                      got.numpy())
        np.testing.assert_array_equal(got.numpy(),
                                      K.mhd_residual_plain(torch.tensor(f)).numpy())


@pytest.mark.parametrize("single_pass,interpret", [(False, None), (True, None),
                                                   (False, True), (True, True)])
def test_mhd_joint_cp_scores_match_cppre(single_pass, interpret):
    truth = _mhd_fields(2, (5, 6, 8, 16, 12))
    pred = truth + 0.1 * np.random.default_rng(3).standard_normal(truth.shape).astype(np.float32)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    got = K.mhd_induction_joint_cp_scores_fused(tt, tp, eps=1e-6, single_pass=single_pass)
    want = jsk.mhd_induction_joint_cp_scores_fused(jnp.asarray(truth), jnp.asarray(pred),
                                                   eps=1e-6, interpret=interpret,
                                                   single_pass=single_pass)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
    two = K.mhd_induction_joint_cp_scores_fused(tt, tp, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), two.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(
        two.numpy(), K.mhd_induction_joint_cp_scores_plain(tt, tp, eps=1e-6).numpy())
    d, s, q = K.mhd_joint_cp_diff_stats(tt, tp, "induction")
    np.testing.assert_array_equal(
        d.numpy(), (K.mhd_residual_fused(tt) - K.mhd_residual_fused(tp)).numpy())
    for a, b in zip((d, s, q), K.mhd_joint_cp_diff_stats_plain(tt, tp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("interpret", [None, True])
def test_ns_single_pass_scores_match_cppre(interpret):
    """K9's NS instance: `ns_joint_cp_scores_fused(single_pass=True)`."""
    rng = np.random.default_rng(12)
    truth = rng.standard_normal((4, 3, 8, 16, 24)).astype(np.float32)
    pred = truth + 0.1 * rng.standard_normal(truth.shape).astype(np.float32)
    args = (0.01, 0.02, 0.02, 1e-3)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    one = K.ns_joint_cp_scores_fused(tt, tp, *args, single_pass=True)
    want = jsk.ns_joint_cp_scores_fused(jnp.asarray(truth), jnp.asarray(pred), *args,
                                        interpret=interpret, single_pass=True)
    np.testing.assert_allclose(one.numpy(), np.asarray(want), rtol=2e-3)
    np.testing.assert_allclose(one.numpy(), K.ns_joint_cp_scores_fused(tt, tp, *args).numpy(),
                               rtol=1e-6)


SOLVER = dict(N=16, boxsize=1.0, tEnd=0.1, dt=1e-3, store_every=10)


def test_solver_matches_cppre():
    """100 steps at N=16: one design through `mhd_solve`, two through
    `mhd_solve_batch`."""
    s = SOLVER
    ours = mhd_solve(s["N"], s["boxsize"], s["tEnd"], 0.7, 0.8, 0.6, dt=s["dt"],
                     store_every=s["store_every"], device="cpu")
    ref = jmhd_solve(s["N"], s["boxsize"], s["tEnd"], 0.7, 0.8, 0.6, dt=s["dt"],
                     store_every=s["store_every"])
    for a, b in zip(ours[:6], ref[:6]):
        assert tuple(a.shape) == b.shape == (11, 16, 16)
        _close(a.numpy(), b, 1e-5)
    assert ours[6] == ref[6]
    np.testing.assert_array_equal(ours[7], ref[7])
    # max |div B| dx: rounding noise of a divergence-free field
    assert 0 <= ours[8] < 1e-5 and 0 <= ref[8] < 1e-5
    designs = np.asarray([[0.7, 0.8, 0.6], [0.5, 0.9, 1.0]], np.float32)
    batch = mhd_solve_batch(designs, s["N"], s["boxsize"], s["tEnd"], dt=s["dt"],
                            store_every=s["store_every"], device="cpu")
    jbatch = jmhd_solve_batch(designs, s["N"], s["boxsize"], s["tEnd"], dt=s["dt"],
                              store_every=s["store_every"])
    for a, b in zip(batch, jbatch):
        assert tuple(a.shape) == (2, 11, 16, 16)
        _close(a.numpy(), b, 1e-5)
    # the batch does not mix designs: its first is the single run
    for a, b in zip(batch, ours[:6]):
        np.testing.assert_array_equal(a[0].numpy(), b.numpy())


TINY = {"N": 16, "tEnd": 0.1, "dt": 1e-3, "t_slice": 25, "T_out": 3, "n_train": 0,
        "n_cal": 10, "n_pred": 6, "Width_time": 4, "Modes": 3}
# the end-to-end runs at an 8^2 grid and 6 + 4 designs (JAX's compiles, not
# the sizes, dominate their time on the CPU)
RUN = dict(TINY, N=8, n_cal=6, n_pred=4)


@pytest.mark.parametrize("box", [None, ([1.0, 1.0, 1.0], [1.5, 1.5, 1.5])])
def test_gen_data_matches_cppre(box):
    lb, ub = box or (None, None)
    data, dt_eff, dx = mhd.gen_data(dict(mhd.CONFIG, **TINY), 3, seed=4, lb=lb, ub=ub,
                                    device="cpu")
    jdata, jdt, jdx = jmhd.gen_data(dict(jmhd.CONFIG, **TINY), 3, seed=4, lb=lb, ub=ub)
    assert tuple(data.shape) == jdata.shape == (3, 6, 16, 16, 5)
    assert (dt_eff, dx) == (jdt, jdx)
    _close(data.numpy(), jdata, 1e-5)


def _carried(nv, width, modes, nx):
    """flax FNO2d params made from seeded port weights (through cppre's
    `fno_params_from_torch`), and those params carried into a fresh port
    model by `fno2d_from_jax`."""
    jm = JFNO2d(T_in=1, step=1, modes1=modes, modes2=modes, num_vars=nv, width_time=width)
    src = FNO2d(1, 1, modes, modes, nv, width, device="cpu",
                generator=torch.Generator().manual_seed(nv + width))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, nv, nx, nx, 1)))
    params = jax.device_get(fno_params_from_torch(src.state_dict(), template))
    model = fno2d_from_jax(params, FNO2d(1, 1, modes, modes, nv, width, device="cpu"))
    for key, value in src.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    return jm, params, model


@pytest.mark.parametrize("mode", ["joint", "marginal"])
def test_mhd_run_matches_cppre(mode):
    """`mhd.run` end to end (solver, normalisation, rollout, K2 induction
    residual, CP with the 1e-6 guard) from cppre's weights carried over by
    `fno2d_from_jax`. Frames 25 ms apart keep the joint modulation well
    above the float32 noise of the two rollouts (at 5 ms the AER+PRE qhat
    moves by 1e-2)."""
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=6, width_time=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 6, 8, 8, 1))))
    model = fno2d_from_jax(params, FNO2d(1, 1, 3, 3, 6, 4, device="cpu"))
    ours = mhd.run(mode, config=RUN, params=model.state_dict(), verbose=False, device="cpu",
                   return_residuals=True)
    ref = jmhd.run(mode, config=RUN, params=params, verbose=False, return_residuals=True)
    assert tuple(ours["res_pred"].shape) == np.asarray(ref["res_pred"]).shape == (4, 1, 6, 6)
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


def test_mhd_training_smoke():
    """Training through the fused apply (its plain version on the CPU) on
    the MHD configuration cut to an 8^2 grid, one step of one epoch."""
    cfg = dict(RUN, n_train=2, n_cal=4, n_pred=2, Epochs=1, **{"Batch Size": 2})
    out = mhd.run("joint", config=cfg, verbose=False, device="cpu")
    assert len(out["train_losses"]) == 1 and np.isfinite(out["train_losses"]).all()
    assert out["pred_cal"].shape == (4, 6, 8, 8, 3) and np.isfinite(out["qhat"]).all()


def test_fno2d_from_jax_carries_the_mhd_model():
    """The flagship MHD model (width 16, modes 8, six variables): the
    carried weights give cppre's forward."""
    jm, params, model = _carried(6, 16, 8, 16)
    x = np.random.default_rng(5).standard_normal((2, 6, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    _close(got, want, 1e-5)
