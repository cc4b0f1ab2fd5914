"""The 1-D Burgers family of cppre_torch against cppre: the spectral
solver, `PRE_Burgers`, `burgers.run`, and its refusal of a window longer
than the data, where cppre fails in training.

Inputs come from numpy seeds and go through both packages on the CPU; the
end-to-end tests give both packages the same weights by replacing their
`fit` (the `same_weights` fixture of `test_torch_advection.py`).

Tolerances:
* the solver: 1e-5 of max|u| at its configured grid (Nx 200, Nt 21), 2e-5
  at Nx 64 (Nt 11): the two libraries' float32 FFTs round differently,
  and the difference grows as the shocks steepen, to 7.6e-6 of max at
  Nx 200 (frame 8 of 20) and 1.06e-5 at Nx 64 (frame 9 of 10);
* `PRE_Burgers`: 1e-6 of max|residual|;
* `run`: the residuals each CP call takes at 5e-5 of max (the solver's
  float32 drift is 2.2e-5 of max|u| on the tests' Nx 32 grid), and the
  port's CP functions on cppre's residuals give cppre's coverage (equal)
  and joint qhat (1e-3 relative), as in `test_torch_advection.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import burgers as jburgers
from cppre.residuals.burgers import PRE_Burgers as JPRE_Burgers
from cppre.solvers.burgers1d import Burgers1D as JBurgers1D
from cppre_torch.experiments import burgers
from cppre_torch.experiments.common import sample_params
from cppre_torch.residuals import PRE_Burgers
from cppre_torch.solvers import Burgers1D
from test_torch_advection import _close, _rng, _same_residuals_and_cp, same_weights  # noqa: F401
from test_torch_ops1d import one_torch_thread  # noqa: F401

BURGERS_TINY = {"Nx": 32, "Nt": 6, "n_train": 4, "n_cal": 6, "n_pred": 4, "T_out": 4,
                "Width": 4, "Modes": 3}


@pytest.mark.parametrize("nx,nt,tol", [(200, 21, 1e-5), (64, 11, 2e-5)])
def test_burgers_solver_matches_cppre(nx, nt, tol):
    p = sample_params(burgers.LB, burgers.UB, 8, 0)
    sim = Burgers1D(nx, nt, 0.0, 2.0, 0.5, 0.002, device="cpu")
    jsim = JBurgers1D(nx, nt, 0.0, 2.0, 0.5, 0.002)
    assert (sim.dt, sim.dx, sim.substeps) == (jsim.dt, jsim.dx, jsim.substeps)
    _close(sim.solve_batch(p), np.asarray(jsim.solve_batch(p)), tol)


@pytest.mark.parametrize("boundary", [False, True])
def test_pre_burgers_matches_cppre(boundary):
    u = 3 * _rng(8).standard_normal((3, 12, 29)).astype(np.float32)
    pre, jpre = PRE_Burgers(0.025, 0.01), JPRE_Burgers(0.025, 0.01)
    _close(pre(torch.tensor(u), boundary=boundary), jpre(jnp.asarray(u), boundary=boundary),
           1e-6)


def _burgers_pair(same_weights, tiny):
    calls = same_weights(jburgers, burgers, dict(burgers.CONFIG, **tiny))
    ours = burgers.run("joint", config=tiny, verbose=False, device="cpu",
                       return_residuals=True)
    ref = jburgers.run("joint", config=tiny, verbose=False)
    np.testing.assert_allclose(ours["mse"], ref["mse"], rtol=1e-5)
    aer = [ours[k] for k in ("res_out_cal", "res_pred_cal", "res_pred", "res_out_pred")]
    _same_residuals_and_cp(calls, {("joint_cp", "aer+pre", False): aer,
                                   ("joint_cp", "pre", False): aer[:3],
                                   ("joint_cp", "aer+pre", True): aer}, 5e-5)


def test_burgers_run_matches_cppre(same_weights):
    _burgers_pair(same_weights, BURGERS_TINY)


def test_burgers_window_longer_than_the_data(same_weights):
    """cppre's `run_initial("Burgers")` window (T_in 20 + T_out 30) does not
    fit Burgers' Nt 21: cppre fails in training with a TypeError, the port
    refuses before solving with a ValueError naming the three numbers. With
    Nt 51 both run, and agree."""
    tiny = dict(BURGERS_TINY, Epochs=1, Nt=21, T_in=20, T_out=30, Step=30,
                **{"Batch Size": 2})
    with pytest.raises(TypeError):
        jburgers.run("joint", config=tiny, verbose=False)
    with pytest.raises(ValueError, match=r"20 \+ 30 = 50 frames.*Nt = 21"):
        burgers.run("joint", config=tiny, verbose=False, device="cpu")
    _burgers_pair(same_weights, dict(tiny, Nt=51))


def test_burgers_refuses_other_train_precisions():
    """cppre's four precisions run (tests/test_torch_train_options.py); any
    other name is refused."""
    with pytest.raises(ValueError, match="unknown precision"):
        burgers.run("joint", config=BURGERS_TINY, train_precision="fp8", device="cpu")


def test_fit_smoke():
    """The real `fit`: 1 epoch on 4 samples; the losses and qhat are finite."""
    cfg = dict(BURGERS_TINY, Epochs=1, **{"Batch Size": 2})
    out = burgers.run("joint", config=cfg, verbose=False, device="cpu")
    assert len(out["train_losses"]) == 1 and np.isfinite(out["train_losses"]).all()
    assert np.isfinite(out["qhat"]).all() and out["train_time"] > 0
