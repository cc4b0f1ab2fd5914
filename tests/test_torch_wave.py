"""The wave family of cppre_torch against cppre: `PRE_Wave`, kernel K8
(`fused_stencil_residual`, `wave_residual_fused`), K1's wave instance
(`wave_joint_cp_scores_fused`), the spectral solver, `gen_data`,
`wave.run` and the carry-over of the wave model's weights.

Inputs come from numpy seeds and go through both packages on the CPU; the
port's kernel wrappers take their plain versions there. cppre runs its
off-TPU path, and its Pallas kernels in interpret mode in one case each.

Tolerances:
* `PRE_Wave`: 1e-6 of max|residual|;
* K8 against cppre's kernel: 2e-6 absolute, as `tests/test_pallas_kernels.py`
  holds cppre's own kernel to its reference;
* joint-CP scores: 2e-3 relative (the rule of `tests/test_pallas_kernels.py`);
* the solver: 1e-5 of max|u| (float32 FFTs of two libraries over 100
  leapfrog steps);
* `wave.run` from the same weights: qhat 1e-3 relative, joint coverage counts
  equal, marginal (per-cell) counts within 0.5% of the cells. The weights
  are cppre's initialisation from a fixed key: the in-sample PRE-only
  estimator of an untrained surrogate divides its residual by that
  residual's own spread over the samples, which is ~1e-5 of its scale in
  places, so float32 rounding of the two rollouts can move a sample across
  qhat under other weights; with these weights it moves none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import wave as jwave
from cppre.models import FNO2d as JFNO2d
from cppre.ops.pallas import stencil_kernels as jsk
from cppre.residuals.wave import PRE_Wave as JPRE_Wave
from cppre.solvers.wave2d_spectral import Wave2D as JWave2D
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import wave
from cppre_torch.models import FNO2d
from cppre_torch.ops import kernels as K
from cppre_torch.residuals import PRE_Wave
from cppre_torch.solvers import Wave2D, Wave_2D
from cppre_torch.utils import fno2d_from_jax

DT, DX, C = 0.05, 2.0 / 15, 1.0


def _rng(seed):
    return np.random.default_rng(seed)


def _field(seed, shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _wave_kernel(k):
    """The wave composite kernel (k = 3), or a random odd k^3 kernel with
    zeros in it (k = 5)."""
    if k == 3:
        return PRE_Wave(DT, DX, C).D.kernel
    kern = _field(40 + k, (k, k, k))
    kern[_rng(41).random(kern.shape) < 0.4] = 0.0
    return kern


@pytest.mark.parametrize("ndim,boundary", [(4, False), (4, True), (5, False)])
def test_pre_wave_matches_cppre(ndim, boundary):
    f = _field(0, (3, 7, 12, 10) if ndim == 4 else (3, 1, 7, 12, 10))
    ours = PRE_Wave(DT, DX, C)
    ref = JPRE_Wave(DT, DX, C)
    np.testing.assert_array_equal(ours.D.kernel, np.asarray(ref.D.kernel))
    got = ours(torch.tensor(f), boundary=boundary).numpy()
    want = np.asarray(ref(jnp.asarray(f), boundary=boundary))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k,take_abs,interpret", [(3, False, None), (3, True, True),
                                                  (5, False, None), (5, True, None)])
def test_stencil_kernel_matches_cppre(k, take_abs, interpret):
    f = _field(1, (3, 9, 14, 11))
    kern = _wave_kernel(k)
    got = K.fused_stencil_residual(torch.tensor(f), kern, take_abs=take_abs)
    want = jsk.fused_stencil_residual(jnp.asarray(f), kern, take_abs=take_abs,
                                      interpret=interpret)
    assert tuple(got.shape) == (3, 9 - k + 1, 14 - k + 1, 11 - k + 1) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    if k == 3 and not take_abs:
        # the experiment's name for it, and the class it is the kernel of
        np.testing.assert_array_equal(K.wave_residual_fused(torch.tensor(f), kern).numpy(),
                                      got.numpy())
        np.testing.assert_allclose(got.numpy(), PRE_Wave(DT, DX, C)(torch.tensor(f)).numpy(),
                                   rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k,interpret", [(3, None), (3, True), (5, None)])
def test_wave_joint_cp_scores_match_cppre(k, interpret):
    truth = _field(2, (6, 8, 13, 12))
    pred = truth + 0.1 * _field(3, truth.shape)
    kern = _wave_kernel(k)
    tt, tp = torch.tensor(truth), torch.tensor(pred)
    scores = K.wave_joint_cp_scores_fused(tt, tp, kern, eps=1e-6)
    want = jsk.wave_joint_cp_scores_fused(jnp.asarray(truth), jnp.asarray(pred), kern,
                                          eps=1e-6, interpret=interpret)
    assert scores.shape == (6,)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=2e-3)
    np.testing.assert_array_equal(scores.numpy(),
                                  K.wave_joint_cp_scores_plain(tt, tp, kern, eps=1e-6).numpy())
    d, s, q = K.wave_joint_cp_diff_stats(tt, tp, kern)
    ro = K.fused_stencil_residual(tt, kern)
    rp = K.fused_stencil_residual(tp, kern)
    np.testing.assert_array_equal(d.numpy(), (ro - rp).numpy())
    np.testing.assert_allclose(s.numpy(), (ro - rp).sum(0).numpy(), rtol=1e-5, atol=1e-5)
    assert q.shape == d.shape[1:]


def test_solver_matches_cppre():
    ours, ref = Wave2D(16, -1.0, 1.0, 1.0, C, device="cpu"), JWave2D(16, -1.0, 1.0, 1.0, C)
    assert Wave_2D is Wave2D
    assert (ours.dt, ours.dx, ours.Nt) == (ref.dt, ref.dx, ref.Nt)
    np.testing.assert_array_equal(ours.t, ref.t)
    designs = np.asarray([[20.0, 0.25, 0.3], [45.0, 0.1, 0.45], [12.0, 0.5, 0.2]], np.float32)
    u, ju = ours.solve_batch(designs).numpy(), np.asarray(ref.solve_batch(designs))
    assert u.shape == (3, 101, 16, 16)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-5 * np.abs(ju).max())
    x, y, t, u1 = ours.solve(30.0, 0.2, 0.35)
    np.testing.assert_allclose(u1.numpy(), ref.solve(30.0, 0.2, 0.35)[3], rtol=0,
                               atol=1e-5 * np.abs(ju).max())
    np.testing.assert_allclose(ours.initialise(30.0, 0.2, 0.35),
                               ref.initialise(30.0, 0.2, 0.35), rtol=1e-6, atol=1e-30)
    u0 = np.outer(np.sin(np.pi * ours.x), np.sin(np.pi * ours.y))
    np.testing.assert_allclose(ours.solve_from(u0).numpy(), ref.solve_from(u0), rtol=0,
                               atol=1e-5)


TINY = {"Nx": 16, "T_out": 3, "t_slice": 25, "n_train": 0, "n_cal": 10, "n_pred": 6,
        "Width_time": 4, "Modes": 3}


def test_gen_data_matches_cppre():
    data, dt_eff, dx = wave.gen_data(dict(wave.CONFIG, **TINY), 5, seed=2, device="cpu")
    jdata, jdt, jdx = jwave.gen_data(dict(jwave.CONFIG, **TINY), 5, seed=2)
    assert tuple(data.shape) == jdata.shape == (5, 1, 16, 16, 5)
    assert (dt_eff, dx) == (jdt, jdx)
    np.testing.assert_allclose(data.numpy(), jdata, rtol=0, atol=1e-5 * np.abs(jdata).max())


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


def _same_cp(ours, ref, mode):
    """qhat at 1e-3; coverage counts equal (joint) or within 0.5% of the
    cells (marginal)."""
    q, jq = np.asarray(ours["qhat"]), np.asarray(ref["qhat"])
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-3 * np.abs(jq).max())
    n = ours["config"]["n_pred"] if mode == "joint" else ours["res_pred"].numel()
    slack = 0 if mode == "joint" else 0.005 * n
    for key in ("coverage_aer_pre", "coverage_pre", "coverage_aer_pre_holdout",
                "coverage_pre_holdout"):
        if ref[key] is None:
            assert ours[key] is None, key
            continue
        np.testing.assert_allclose(np.round(np.asarray(ours[key]) * n),
                                   np.round(np.asarray(ref[key]) * n), rtol=0, atol=slack,
                                   err_msg=key)


@pytest.mark.parametrize("mode", ["joint", "marginal"])
def test_wave_run_matches_cppre(mode):
    """`wave.run` end to end (solver, normalisation, rollout, K8 residual,
    CP) from cppre's weights carried over by `fno2d_from_jax`."""
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=1, width_time=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 16, 16, 1))))
    model = fno2d_from_jax(params, FNO2d(1, 1, 3, 3, 1, 4, device="cpu"))
    ours = wave.run(mode, config=TINY, params=model.state_dict(), verbose=False,
                    device="cpu", return_residuals=True)
    ref = jwave.run(mode, config=TINY, params=params, verbose=False, return_residuals=True)
    assert tuple(ours["res_pred"].shape) == np.asarray(ref["res_pred"]).shape == (6, 1, 14, 14)
    _same_cp(ours, ref, mode)
    assert ours["data_time"] > 0


def test_wave_training_smoke():
    """Training through the fused apply (its plain version on the CPU) on
    the wave configuration cut to a 16^2 grid and 1 epoch."""
    cfg = dict(TINY, n_train=4, n_cal=4, n_pred=4, Epochs=1, **{"Batch Size": 2})
    out = wave.run("joint", config=cfg, verbose=False, device="cpu")
    assert len(out["train_losses"]) == 1 and np.isfinite(out["train_losses"]).all()
    assert out["pred_cal"].shape == (4, 1, 16, 16, 3) and np.isfinite(out["qhat"]).all()


def test_fno2d_from_jax_carries_the_wave_model():
    """The flagship wave model (width 32, modes 16, one variable): the
    carried weights give cppre's forward."""
    jm, params, model = _carried(1, 32, 16, 32)
    x = _field(5, (2, 1, 32, 32, 1))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_scores_take_the_centred_variance():
    """Where a cell's diff barely varies over the batch (std 1e-4 of its
    mean), the one-pass sumsq / n - mean^2 of cppre's fused scores cancels
    in float32; the port's scores take the centred sum of squares and agree
    with `modulation_func` + `ncf_metric_joint` (a two-pass std), on both
    the two-pass and the single-pass route."""
    from cppre.cp.inductive import modulation_func, ncf_metric_joint

    centre = np.zeros((3, 3, 3), np.float32)
    centre[1, 1, 1] = 1.0                        # the residual is the interior
    rng = _rng(9)
    truth = (1.0 + 1e-4 * rng.standard_normal((40, 5, 8, 9))).astype(np.float32)
    pred = np.zeros_like(truth)
    ro, rp = truth[:, None, 1:-1, 1:-1, 1:-1], pred[:, None, 1:-1, 1:-1, 1:-1]
    want = np.asarray(ncf_metric_joint(jnp.asarray(ro), jnp.asarray(rp),
                                       modulation_func(jnp.asarray(ro), jnp.asarray(rp)) + 1e-6))
    got = K.wave_joint_cp_scores_fused(torch.tensor(truth), torch.tensor(pred), centre)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    one_pass = np.asarray(jsk.wave_joint_cp_scores_fused(jnp.asarray(truth), jnp.asarray(pred),
                                                         centre))
    assert np.abs(one_pass / want - 1).max() > 1e-2   # the fault this avoids
    t6 = np.zeros((40, 6, 5, 8, 9), np.float32)
    t6[:, 4] = truth                                  # d_t(Bx) carries the signal
    t6[:, 4] *= np.arange(5, dtype=np.float32)[:, None, None]
    tt = torch.tensor(t6)
    two = K.mhd_induction_joint_cp_scores_fused(tt, torch.zeros_like(tt))
    one = K.mhd_induction_joint_cp_scores_fused(tt, torch.zeros_like(tt), single_pass=True)
    np.testing.assert_allclose(one.numpy(), two.numpy(), rtol=1e-6)


def test_discretisation_sweep_matches_cppre():
    """The marginal rebuttal study: the same data and weights, marginal
    coverage per temporal discretisation within 0.5% of the cells."""
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=1, width_time=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 16, 16, 1))))
    model = fno2d_from_jax(params, FNO2d(1, 1, 3, 3, 1, 4, device="cpu"))
    cfg = dict(TINY, T_out=6, t_slice=10)
    data = np.asarray(jwave.gen_data(dict(jwave.CONFIG, **cfg), 8, seed=3)[0])
    ours = wave.discretisation_sweep(data, model.state_dict(), discs=(1, 2), config=cfg,
                                     verbose=False, device="cpu")
    ref = jwave.discretisation_sweep(data, params, discs=(1, 2), config=cfg, verbose=False)
    for disc in (1, 2):
        n = 4 * 14 * 14 * (4 if disc == 1 else 1)       # scored cells
        np.testing.assert_allclose(np.round(np.asarray(ours[disc]) * n),
                                   np.round(np.asarray(ref[disc]) * n), rtol=0,
                                   atol=0.005 * n, err_msg=f"disc={disc}")
