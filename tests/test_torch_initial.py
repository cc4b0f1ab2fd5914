"""The offline `Expts_initial` pipelines of cppre_torch against cppre:
`run_offline` (a saved dataset, weights and normalizers, marginal CP and
the inverted bounds) and `run_initial` by family.

Inputs come from numpy seeds and go through both packages on the CPU. The
port's `run_offline` takes cppre's weights carried by `fno2d_from_jax` and
reads the normalizers that cppre's `save_norms` wrote; `run_initial`
replaces `fit` in both packages (the `same_weights` fixture of
`test_torch_advection.py`).

Tolerances:
* `run_offline`: mse 1e-5 relative; coverage counts within 0.5 % of the
  cells (the marginal rule of the 2-D tests); the inverted bounds at 1e-4
  of max|bounds| outside the wave stencil's null modes (`null_free` over
  t, x and y);
* `run_initial("Advection")`: as `advection.run` in
  `test_torch_advection.py` (residuals 1e-5 of max, qhat 1e-5 of max,
  coverage counts within 0.5 % of the cells, bounds 1e-4 outside the null
  modes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cppre.experiments import advection as jadv
from cppre.experiments import initial as jinitial
from cppre.models import FNO2d as JFNO2d
from cppre.residuals.wave import PRE_Wave as JPRE_Wave
from cppre.train.normalizers import MinMaxNormalizer as JMinMax
from cppre.utils.checkpoint import save_norms as jsave_norms
from cppre_torch.experiments import advection, initial
from cppre_torch.models import FNO2d
from cppre_torch.residuals import PRE_Wave
from cppre_torch.utils import fno2d_from_jax, save_checkpoint
from test_torch_advection import _same_cp, _same_residuals_and_cp, same_weights  # noqa: F401
from test_torch_ops1d import null_free, one_torch_thread  # noqa: F401

CFG = {"T_in": 1, "T_out": 4, "Step": 1, "Modes": 3, "Variables": 1, "Width_time": 4,
       "n_cal": 6}
DT, DX = 0.02, 0.1


def _fields(n=10, nx=12, nt=6, seed=0):
    """Smooth standing-wave fields [n, 1, nx, nx, nt]."""
    r = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx)
    t = np.arange(nt) * DT
    k = r.uniform(1, 2, (n, 1, 1, 1))
    f = (np.sin(np.pi * k * x[None, :, None, None]) * np.sin(np.pi * k * x[None, None, :, None])
         * np.cos(2 * np.pi * k * t[None, None, None, :]))
    return (f + 0.01 * r.standard_normal(f.shape))[:, None].astype(np.float32)


def test_run_offline_matches_cppre(tmp_path):
    """From a saved npz, cppre's weights (as a port checkpoint, and as a
    state dict), and the normalizers cppre's `save_norms` wrote."""
    data = _fields()
    np.savez(tmp_path / "data.npz", fields=data)
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=1, width_time=4)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3),
                                             jnp.zeros((1, 1, 12, 12, 1))))
    model = fno2d_from_jax(params, FNO2d(1, 1, 3, 3, 1, 4, device="cpu"))
    a, u = jnp.asarray(data[..., :1]), jnp.asarray(data[..., 1:5])
    norms = jsave_norms(str(tmp_path / "wave"), JMinMax(a), JMinMax(u))
    jpre = JPRE_Wave(DT, DX)
    ref = jinitial.run_offline(data=str(tmp_path / "data.npz"), residual_fn=jpre.__call__,
                               cfg=CFG, params=params, norms=norms, invert_with=jpre.D,
                               verbose=False)
    n_cells = 4 * 2 * 10 * 10   # n_pred x the interior of [Nt 4, 12, 12]
    for kw in (dict(ckpt=save_checkpoint(str(tmp_path / "FNO_Wave_run1"), model)),
               dict(params=model.state_dict())):
        ours = initial.run_offline(data=str(tmp_path / "data.npz"), residual_fn=PRE_Wave(DT, DX),
                                   cfg=CFG, norms=norms, invert_with=PRE_Wave(DT, DX).D,
                                   verbose=False, device="cpu", **kw)
        np.testing.assert_allclose(ours["mse"], ref["mse"], rtol=1e-5)
        np.testing.assert_array_equal(ours["alphas"], ref["alphas"])
        np.testing.assert_allclose(np.round(ours["coverage"] * n_cells),
                                   np.round(ref["coverage"] * n_cells), rtol=0,
                                   atol=0.005 * n_cells)
        for got, want in zip(ours["inverted_bounds"], ref["inverted_bounds"]):
            assert got.shape == want.shape == (4, 6, 14, 14) and np.isfinite(got).all()
            np.testing.assert_allclose(null_free(got, 3), null_free(want, 3), rtol=0,
                                       atol=1e-4 * np.abs(want).max())


def test_run_offline_needs_a_surrogate():
    with pytest.raises(ValueError, match="pretrained surrogate"):
        initial.run_offline(data=_fields(), residual_fn=PRE_Wave(DT, DX), cfg=CFG,
                            device="cpu")


def test_run_initial_advection_matches_cppre(same_weights):
    """The historical advection pipeline at the tiny configuration of
    `tests/test_experiments.py` (T_in 10, single-shot step 16), with the
    same weights in both packages."""
    tiny = {"Epochs": 2, "Nx": 64, "Nt": 80, "n_train": 8, "n_cal": 8, "n_pred": 4,
            "T_in": 10, "T_out": 16, "Step": 16, "Width": 8, "Modes": 4, "Batch Size": 4}
    calls = same_weights(jadv, advection,
                         {**advection.CONFIG, **initial.INITIAL_CONFIGS["Advection"], **tiny})
    ours = initial.run_initial("Advection", config=tiny, verbose=False, device="cpu",
                               return_residuals=True)
    ref = jinitial.run_initial("Advection", config=tiny, verbose=False)
    assert ours["mode"] == ref["mode"] == "marginal"
    aer = [ours[k] for k in ("res_out_cal", "res_pred_cal", "res_pred_test", "res_out_test")]
    pre = aer[:2] + [ours["pred_residual"]]
    _same_residuals_and_cp(calls, {("marginal_cp", "aer+pre", False): aer,
                                   ("marginal_cp", "pre", False): pre}, 1e-5)
    _same_cp(ours, ref, ours["res_out_test"].numel(), joint=False)
    for got, want in zip(ours["inverted_bounds"], ref["inverted_bounds"]):
        assert got.shape == np.shape(want) and np.isfinite(got).all()
        np.testing.assert_allclose(null_free(got), null_free(want), rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_run_initial_dispatch():
    """cppre's configurations; an unknown case and the Burgers window
    (T_in 20 + T_out 30 > Nt 21) refused before any work."""
    assert initial.INITIAL_CONFIGS == jinitial.INITIAL_CONFIGS
    with pytest.raises(ValueError, match="unknown Expts_initial case"):
        initial.run_initial("Heat", device="cpu")
    with pytest.raises(ValueError, match="Nt = 21"):
        initial.run_initial("Burgers", device="cpu")
