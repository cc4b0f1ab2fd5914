"""The 1-D advection family of cppre_torch against cppre: `FNO1d` and
`fno1d_from_jax`, the AR rollout loss and its gradients, the advection
solver, `PRE_Advection` and `advection.run` (the Burgers family is in
`test_torch_burgers.py`).

Inputs come from numpy seeds and go through both packages on the CPU.
Neither package's `run` takes weights, so the end-to-end tests replace the
module-level `fit` of both: cppre's returns fixed flax params, the port's
loads the same params, carried by `fno1d_from_jax`, into the model it is
given. Everything after training is then held to cppre.

Tolerances:
* `FNO1d` forward (DFT and FFT paths) from the carried weights: 1e-5 of
  max|cppre|; flax -> port -> `fno_params_from_torch`: bit for bit;
* one `rollout_loss` (T_out / step = 4): the loss at 1e-5 relative, every
  gradient at 1e-4 of the largest |gradient|;
* the advection solver: 1e-6 of max|u|;
* `PRE_Advection`: 1e-6 of max|residual|;
* `run`: the residuals each CP call takes at 1e-5 of max (a residual is a
  difference of O(1) fields, ~0.05 at its largest, so the solver's one
  float32 ulp on a field, 6e-8, is up to 3e-6 of it), and the port's CP functions on cppre's residuals give
  cppre's coverage (equal) and qhat (marginal 1e-5 of max, joint 1e-3
  relative); the marginal run's own qhat at 1e-5 of max|qhat| and
  coverage counts within 0.5 % of the cells (a joint qhat is 1 / the
  smallest modulation, float32 noise in the far field:
  `_same_residuals_and_cp`); the inverted bounds at 1e-4 of max|bounds|
  outside the composite stencil's null modes (`null_free`), where each
  package divides its own FFT's rounding by eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import advection as jadv
from cppre.models import FNO1d as JFNO1d
from cppre.residuals.advection import PRE_Advection as JPRE_Advection
from cppre.solvers.advection1d import Advection1D as JAdvection1D
from cppre.train import loops as jloops
from cppre.train import losses as jlosses
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import advection, pipeline
from cppre_torch.experiments.common import sample_params
from cppre_torch.models import FNO1d
from cppre_torch.residuals import PRE_Advection
from cppre_torch.solvers import Advection1D
from cppre_torch.train import losses
from cppre_torch.train.loops import rollout_loss
from cppre_torch.utils import fno1d_from_jax
from test_torch_ops1d import null_free, one_torch_thread  # noqa: F401

ADV_TINY = {"Nx": 32, "Nt": 24, "n_train": 4, "n_test": 4, "n_cal": 6, "n_pred": 4,
            "T_out": 8, "Width": 4, "Modes": 3}


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _carried(t_in, step, modes, nv, width, nx, seed=0):
    """flax FNO1d params made from seeded port weights (through cppre's
    `fno_params_from_torch`), and those params carried into a fresh port
    model by `fno1d_from_jax`."""
    jm = JFNO1d(T_in=t_in, step=step, modes1=modes, num_vars=nv, width_time=width)
    src = FNO1d(t_in, step, modes, nv, width, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, nv, nx, t_in)))
    params = jax.device_get(fno_params_from_torch(src.state_dict(), template))
    model = fno1d_from_jax(params, FNO1d(t_in, step, modes, nv, width, device="cpu"))
    for key, value in src.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    return jm, params, model


# ---- FNO1d ------------------------------------------------------------------------

@pytest.mark.parametrize("impl,modes,nx", [("dft", 5, 24), ("fft", 5, 24), ("dft", 13, 24)])
def test_fno1d_matches_cppre(impl, modes, nx):
    """The DFT path, the FFT path, and a mode count past Nx//2+1 that the
    DFT path hands to the FFT path, from weights carried by
    `fno1d_from_jax`; then the round trip flax -> port ->
    `fno_params_from_torch` is bit for bit."""
    jm = JFNO1d(T_in=3, step=2, modes1=modes, num_vars=2, width_time=6, spectral_impl=impl)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((1, 2, nx, 3))))
    model = fno1d_from_jax(params, FNO1d(3, 2, modes, 2, 6, spectral_impl=impl, device="cpu"))
    x = _rng(5).standard_normal((3, 2, nx, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.tensor(x))
    _close(got, want, 1e-5)
    back = jax.device_get(fno_params_from_torch(model.state_dict(), params))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fno1d_from_jax_refuses_another_shape():
    _, params, _ = _carried(1, 1, 3, 1, 4, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        fno1d_from_jax(params, FNO1d(1, 1, 4, 1, 4, device="cpu"))


def test_rollout_loss_and_grads_match_cppre():
    """One AR rollout loss (T_in 2, step 1, T_out 4: four chunks) under
    `jax.value_and_grad` and under torch autograd, from the same weights."""
    jm, params, model = _carried(2, 1, 4, 1, 6, 20, seed=3)
    r = _rng(6)
    x = r.standard_normal((3, 1, 20, 2)).astype(np.float32)
    y = r.standard_normal((3, 1, 20, 4)).astype(np.float32)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jloops.rollout_loss(jm.apply, p, jnp.asarray(x), jnp.asarray(y), 1, 4,
                                      jlosses.lp_loss), has_aux=True))(params)
    loss, _ = rollout_loss(model, torch.tensor(x), torch.tensor(y), 1, 4, losses.lp_loss)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    ours = fno_params_from_torch({k: p.grad for k, p in model.named_parameters()}, params)
    ref = jax.tree_util.tree_leaves(jax.device_get(gj))
    scale = max(np.abs(np.asarray(v)).max() for v in ref)
    for a, b in zip(jax.tree_util.tree_leaves(ours), ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-4 * scale)


# ---- solvers -------------------------------------------------------------------------

def test_advection_solver_matches_cppre():
    """An 8-design batch at Nx 64, and one design's upwind and exact
    solutions."""
    p = sample_params(advection.LB, advection.UB, 8, 0)
    got = Advection1D(64, 40, 0.0, 2.0, 0.5, device="cpu").solve_batch(p, 1.0)
    want = np.asarray(JAdvection1D(64, 40, 0.0, 2.0, 0.5).solve_batch(p, 1.0))
    _close(got, want, 1e-6)
    sim, jsim = Advection1D(64, 40, 0.0, 2.0, 0.5, device="cpu"), JAdvection1D(64, 40, 0.0, 2.0,
                                                                               0.5)
    x, t, u, ue = sim.solve(0.7, 80.0, 1.0)
    jx, jt, ju, jue = jsim.solve(0.7, 80.0, 1.0)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(t, jt)
    _close(u, ju, 1e-6)
    _close(ue, jue, 1e-6)
    _close(torch.tensor(sim.initializeU(0.7, 80.0)), jsim.initializeU(0.7, 80.0), 1e-6)
    assert (sim.dt, sim.dx) == (jsim.dt, jsim.dx)


# ---- residuals ---------------------------------------------------------------------

@pytest.mark.parametrize("boundary", [False, True])
@pytest.mark.parametrize("disc", [1, 2])
def test_pre_advection_matches_cppre(disc, boundary):
    u = _rng(7).standard_normal((3, 12, 29)).astype(np.float32)
    pre, jpre = PRE_Advection(0.005, 0.01, v=1.0, disc=disc), JPRE_Advection(0.005, 0.01, 1.0,
                                                                              disc)
    np.testing.assert_array_equal(pre.D.kernel, np.asarray(jpre.D.kernel))
    _close(pre(torch.tensor(u), boundary=boundary), jpre(jnp.asarray(u), boundary=boundary),
           1e-6)


# ---- end to end ------------------------------------------------------------------------

@pytest.fixture
def same_weights(monkeypatch):
    """Replace `fit` in both packages' 1-D experiments: cppre's returns the
    flax params of a seeded model, the port's loads the same params into
    its model. Also records every CP call of cppre's run (`joint_cp`,
    `marginal_cp`: arguments, keywords, result). Returns a function that
    installs both for (module pair, config) and returns the record."""
    def install(jmod, mod, cfg):
        jm = JFNO1d(T_in=cfg["T_in"], step=cfg["Step"], modes1=cfg["Modes"],
                    num_vars=cfg["Variables"], width_time=cfg["Width"])
        params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                                 jnp.zeros((1, 1, 16, cfg["T_in"]))))
        monkeypatch.setattr(jmod, "fit", lambda *a, **k: params)

        def fit(apply_fn, model, *a, **k):
            fno1d_from_jax(params, model)
            return model.state_dict(), []

        monkeypatch.setattr(mod, "fit", fit)
        calls = []
        for name in ("joint_cp", "marginal_cp"):
            def record(*a, _fn=getattr(jmod, name), _name=name, **k):
                out = _fn(*a, **k)
                calls.append((_name, [np.asarray(x) for x in a], k, out))
                return out

            monkeypatch.setattr(jmod, name, record)
        return calls

    return install


def _same_cp(ours, ref, n_cells, joint, keys=("coverage_aer_pre", "coverage_pre",
                                                "coverage_aer_pre_holdout")):
    """qhat at 1e-5 of max; coverage counts equal (joint) or within 0.5 %
    of the cells (marginal)."""
    _close(ours["qhat"], ref["qhat"], 1e-5, "qhat")
    slack = 0 if joint else 0.005 * n_cells
    for key in keys:
        if key not in ref:
            continue
        if ref[key] is None:
            assert ours[key] is None, key
            continue
        np.testing.assert_allclose(np.round(np.asarray(ours[key]) * n_cells),
                                   np.round(np.asarray(ref[key]) * n_cells), rtol=0,
                                   atol=slack, err_msg=key)


def _same_residuals_and_cp(calls, ours, res_tol):
    """Each CP call of cppre's run: the residuals it took against the port
    run's (`res_tol` of max), and the port's CP function on cppre's
    residuals against cppre's result: coverage equal, a marginal qhat at
    1e-5 of max and a joint one at 1e-3 relative (the repo's gate for
    joint-CP qhat between two routes). A joint qhat divides by the
    calibration residuals' spread over the samples, which at cells where
    every sample's residual is the same (the far field of every pulse) is
    float32 noise, ~1e-7: there the two libraries' rounding of that spread
    moves qhat by ~1e-5 on the same residuals, and 1e-7 of difference in
    the residuals moves it by tens of per cent. So the run's joint outputs
    are held through its residuals."""
    assert calls
    for name, args, kwargs, ref in calls:
        for got, want in zip(ours[name, kwargs.get("mode", "aer+pre"),
                                  kwargs.get("holdout_modulation", False)], args):
            _close(got, want, res_tol, name)
        mine = getattr(pipeline, name)(*(torch.tensor(a) for a in args), **kwargs)
        if name == "joint_cp":
            np.testing.assert_allclose(float(mine["qhat"]), float(ref["qhat"]), rtol=1e-3)
        else:
            _close(mine["qhat"], np.asarray(ref["qhat"]), 1e-5, f"{name} qhat")
        n = args[2].shape[0] if name == "joint_cp" else args[2].size   # samples or cells
        np.testing.assert_array_equal(np.round(np.asarray(mine["coverage"]) * n),
                                      np.round(np.asarray(ref["coverage"]) * n))


@pytest.mark.parametrize("mode", ["marginal", "joint"])
def test_advection_run_matches_cppre(mode, same_weights):
    """`advection.run` end to end: solver, one batched rollout, the
    composite PRE, CP, and the inverted bounds."""
    calls = same_weights(jadv, advection, dict(advection.CONFIG, **ADV_TINY))
    ours = advection.run(mode, config=ADV_TINY, verbose=False, device="cpu",
                         return_residuals=True)
    ref = jadv.run(mode, config=ADV_TINY, verbose=False)
    np.testing.assert_allclose(ours["mse"], ref["mse"], rtol=1e-5)
    aer = [ours[k] for k in ("res_out_cal", "res_pred_cal", "res_pred_test", "res_out_test")]
    pre = aer[:2] + [ours["pred_residual"]]
    name = mode + "_cp"
    _same_residuals_and_cp(calls, {(name, "aer+pre", False): aer, (name, "pre", False): pre},
                           1e-5)
    if mode == "marginal":
        _same_cp(ours, ref, ours["res_out_test"].numel(), joint=False)
        assert ours["n_rejected"] == ref["n_rejected"]
    for got, want in zip(ours["inverted_bounds"], ref["inverted_bounds"]):
        want = np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(null_free(got), null_free(want), rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_fit_smoke():
    """The real `fit`: 1 epoch on 4 samples; the losses are finite and the
    marginal CP outputs finite."""
    cfg = dict(ADV_TINY, Epochs=1, **{"Batch Size": 2})
    out = advection.run("marginal", config=cfg, verbose=False, device="cpu")
    assert len(out["train_losses"]) == 1 and np.isfinite(out["train_losses"]).all()
    assert np.isfinite(out["qhat"]).all() and out["train_time"] > 0
