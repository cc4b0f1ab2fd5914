"""The NS experiment half of cppre_torch against cppre: the spectral solver,
the LHS design, the field stacking, `run_2d_cp` and `ns.run`.

Tolerances:
* solver fields: 1e-4 of max|field| (float32 FFT rounding of another
  library, accumulated over 20 RK4 steps);
* the solver's `err`, max |div u|: it is float32 rounding noise of a
  divergence-free field (~2e-5 at N=32), so the two libraries' values
  differ by tens of percent; they must agree to the fields' own tolerance,
  1e-4 of max|u|;
* LHS designs: bit-equal;
* `run_2d_cp` with the same weights: qhat 1e-4 relative, the filter mask
  and the joint coverage counts equal, the marginal (per-cell) counts within
  0.5% of the cells.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cppre.experiments import base2d as jbase2d
from cppre.experiments import common as jcommon
from cppre.models import FNO2d as JFNO2d
from cppre.residuals.ns import PRE_NS as JPRE_NS
from cppre.solvers.ns2d_spectral import NavierStokes2D as JNS2D
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import base2d, common, ns
from cppre_torch.models import FNO2d
from cppre_torch.residuals import PRE_NS
from cppre_torch.solvers import NavierStokes2D
from cppre_torch.utils import fno2d_from_jax

SOLVER = (32, 0.0, 0.02, 1e-3, 1e-3, 1.0)          # N, tStart, tEnd, dt, nu, L


def _fields_close(ours, ref):
    for a, b in zip(ours, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("batch", [False, True])
def test_solver_matches_cppre(batch):
    ours = NavierStokes2D(*SOLVER, store_every=5, device="cpu")
    ref = JNS2D(*SOLVER, store_every=5)
    assert ours.n_steps == ref.n_steps and np.array_equal(ours.t, ref.t)
    if batch:
        designs = np.asarray([[0.6, 0.9], [0.8, 0.55], [1.0, 0.7]], np.float32)
        _fields_close([f.numpy() for f in ours.solve_batch(designs)], ref.solve_batch(designs))
        return
    u, v, p, w, x, t, err = ours.solve(0.7, 0.8)
    ju, jv, jp, jw, jx, jt, jerr = ref.solve(0.7, 0.8)
    assert u.shape == (5, 32, 32)
    _fields_close([u.numpy(), v.numpy(), p.numpy(), w.numpy()], [ju, jv, jp, jw])
    np.testing.assert_array_equal(x, jx)
    assert abs(err - jerr) <= 1e-4 * np.abs(ju).max()


def test_lhs_and_field_stacking_match_cppre():
    np.testing.assert_array_equal(common.latin_hypercube(3, 17, seed=5),
                                  jcommon.latin_hypercube(3, 17, seed=5))
    np.testing.assert_array_equal(common.sample_params(ns.LB, ns.UB, 30, seed=1),
                                  jcommon.sample_params(ns.LB, ns.UB, 30, seed=1))
    r = np.random.default_rng(0)
    parts = [r.standard_normal((2, 5, 6, 4)).astype(np.float32) for _ in range(3)]
    stacked = common.stacked_fields([torch.tensor(p) for p in parts])
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(jcommon.stacked_fields(parts)))
    for a, b in zip(common.unstack_fields(stacked), parts):
        np.testing.assert_array_equal(a.numpy(), b)


CFG = {"T_in": 1, "T_out": 3, "Step": 1, "n_train": 0, "n_cal": 8, "n_pred": 8, "Modes": 3,
       "Variables": 3, "Width_time": 4, "Normalisation Strategy": "Min-Max"}
DT, DX, NU = 0.01, 0.01, 1e-3


def _ns_like_data(n=16, nx=12, ny=10, nt=4, seed=0):
    """Smooth-plus-noise NS-like fields [n, 3, Nx, Ny, Nt]."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx)[:, None, None]
    y = np.linspace(0, 1, ny)[None, :, None]
    t = np.arange(nt)[None, None, :] * 0.1
    amp = rng.uniform(0.5, 1.5, size=(n, 3, 1, 1, 1))
    base = np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) * np.exp(-t)
    return (amp * base + 0.05 * rng.standard_normal((n, 3, nx, ny, nt))).astype(np.float32)


@pytest.mark.parametrize("mode", ["joint", "marginal"])
def test_run_2d_cp_matches_cppre(mode):
    """The CP flow with weights given (flax params carried into the port by
    `fno2d_from_jax`): qhat, every coverage of the alpha sweep and the
    filter mask."""
    data = _ns_like_data()
    src = FNO2d(1, 1, 3, 3, 3, 4, device="cpu", generator=torch.Generator().manual_seed(3))
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=3, width_time=4)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 12, 10, 1)))
    params = jax.device_get(fno_params_from_torch(src.state_dict(), template))
    state = fno2d_from_jax(params, FNO2d(1, 1, 3, 3, 3, 4, device="cpu")).state_dict()
    ours = base2d.run_2d_cp(data=data, residual_fn=PRE_NS(DT, DX, DX, NU).residual_momentum,
                            cfg=CFG, mode=mode, params=state, verbose=False, device="cpu",
                            return_residuals=True)
    ref = jbase2d.run_2d_cp(data=jnp.asarray(data),
                            residual_fn=JPRE_NS(DT, DX, DX, NU).residual_momentum, cfg=CFG,
                            mode=mode, params=params, verbose=False)
    q, jq = np.asarray(ours["qhat"]), np.asarray(ref["qhat"])
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-4 * np.abs(jq).max())
    # A coverage is a mean over samples (joint) or over every cell (marginal):
    # compare the counts it stands for. Joint counts are equal. In marginal
    # mode each of the 640 cells has its own band, and a residual within
    # float32 rounding of its band's edge may fall either side: the counts
    # agree to 0.5% of the cells.
    n = CFG["n_pred"] if mode == "joint" else ours["res_pred"].numel()
    slack = 0 if mode == "joint" else 0.005 * n
    for key in ("coverage_aer_pre", "coverage_pre", "coverage_aer_pre_holdout",
                "coverage_pre_holdout"):
        if ref[key] is None:
            assert ours[key] is None, key
        else:
            np.testing.assert_allclose(np.round(np.asarray(ours[key]) * n),
                                       np.round(np.asarray(ref[key]) * n), rtol=0, atol=slack,
                                       err_msg=key)
    for key in ("alphas", "filter_mask"):
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(ref[key]), key)
    np.testing.assert_allclose(ours["mse"], ref["mse"], rtol=1e-4)


@pytest.mark.parametrize("mode,variables", [("joint", 3), ("marginal", 4)])
def test_ns_run_end_to_end_tiny(mode, variables):
    """The experiment from solver to coverage on a tiny configuration
    (N=32 sliced to 8x8, 4 frames, 12 sims, 1 epoch), through the fused
    training and rollout paths (their plain versions on the CPU); marginal
    mode with 4 variables adds the periodic-BC coverage."""
    cfg = {"N": 32, "tEnd": 0.03, "t_slice": 10, "x_slice": 4, "T_out": 3, "Epochs": 1,
           "Batch Size": 2, "n_train": 4, "n_cal": 4, "n_pred": 4, "Width_time": 4,
           "Modes": 3, "Variables": variables}
    out = ns.run(mode, config=cfg, verbose=False, device="cpu")
    assert out["pred_cal"].shape == (4, variables, 8, 8, 3)
    assert len(out["train_losses"]) == 1 and np.isfinite(out["train_losses"]).all()
    assert np.isfinite(out["qhat"]).all() and out["data_time"] > 0
    assert len(out["coverage_aer_pre"]) == len(out["alphas"])
    if variables == 4:
        assert len(out["bc_coverage"]) == len(out["alphas"])
    with pytest.raises(NotImplementedError):
        base2d.run_2d_cp(data=np.zeros((8, 3, 8, 8, 3), np.float32), residual_fn=None,
                         cfg=CFG, mesh=object(), device="cpu")
