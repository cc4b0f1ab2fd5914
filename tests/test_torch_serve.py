"""The slice end to end: cppre_torch.deploy.CalibratedSurrogate vs cppre's.

A tiny NS-shaped setup in both frameworks — FNO2d(T_in=1, step=1, modes 3,
3 variables, width 4) on a 12x10 grid, T_out=3, n_cal = n_pred = 8, the NS
momentum PRE — with the same weights (carried by cppre's importer) and the
same MinMax normalizers (carried by `from_ab`). The port runs both its
plain model and its fused path (on the CPU: the kernels' plain versions).
qhat, modulation and predictions agree to 1e-4 relative (float32 through a
3-step rollout and a sup-norm score); accept masks and coverage counts are
equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cppre.experiments.pipeline as jpipe
from cppre.deploy import CalibratedSurrogate as JSurrogate
from cppre.models import FNO2d as JFNO2d
from cppre.residuals.ns import PRE_NS as JPRE_NS
from cppre.train.normalizers import MinMaxNormalizer as JMinMax
from cppre.utils import fno_params_from_torch
from cppre_torch.deploy import CalibratedSurrogate
from cppre_torch.experiments import pipeline
from cppre_torch.models import FNO2d
from cppre_torch.ops.kernels import ns_momentum_residual_fused
from cppre_torch.utils import normalizer_from_jax

NV, NX, NY, T_IN, T_OUT, N = 3, 12, 10, 1, 3, 8
DT, DX, NU = 0.01, 0.01, 1e-3
REL = 1e-4


def _data(seed=0):
    """Smooth-plus-noise NS-like fields [2N, 3, Nx, Ny, T_in + T_out]."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, NX)[:, None, None]
    y = np.linspace(0, 1, NY)[None, :, None]
    t = np.arange(T_IN + T_OUT)[None, None, :] * 0.1
    amp = rng.uniform(0.5, 1.5, size=(2 * N, NV, 1, 1, 1))
    base = np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) * np.exp(-t)
    fields = amp * base + 0.05 * rng.standard_normal((2 * N, NV, NX, NY, T_IN + T_OUT))
    return fields.astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    data = _data()
    jm = JFNO2d(T_in=T_IN, step=1, modes1=3, modes2=3, num_vars=NV, width_time=4)
    model = FNO2d(T_IN, 1, 3, 3, NV, 4, device="cpu", generator=torch.Generator().manual_seed(0))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, NV, NX, NY, T_IN), jnp.float32))
    params = fno_params_from_torch(model.state_dict(), template)
    j_in, j_out = JMinMax(data[..., :T_IN]), JMinMax(data[..., T_IN:])
    return dict(data=data, jm=jm, params=params, model=model, j_in=j_in, j_out=j_out)


def _surrogates(s, score, fused):
    j_pre = JPRE_NS(DT, DX, DX, NU)
    jsrv = JSurrogate(s["jm"], s["params"], j_pre.residual_momentum, step=1, T_out=T_OUT,
                      in_normalizer=s["j_in"], out_normalizer=s["j_out"], mode="joint",
                      score=score)
    srv = CalibratedSurrogate(
        s["model"], lambda f: ns_momentum_residual_fused(f, DT, DX, DX, NU), step=1,
        T_out=T_OUT, in_normalizer=normalizer_from_jax(s["j_in"], device="cpu"),
        out_normalizer=normalizer_from_jax(s["j_out"], device="cpu"), mode="joint", score=score,
        fused=fused)
    return jsrv, srv


def _rel_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("score,holdout,fused", [("pre", False, False), ("pre", True, True),
                                                 ("aer+pre", False, True),
                                                 ("aer+pre", True, False)])
def test_surrogate_matches_cppre(setup, score, holdout, fused):
    data = setup["data"]
    cal_a, cal_u = data[:N, ..., :T_IN], data[:N, ..., T_IN:]
    new_a = data[N:, ..., :T_IN]
    jsrv, srv = _surrogates(setup, score, fused)
    jsrv.calibrate(jnp.asarray(cal_a), jnp.asarray(cal_u), alpha=0.2, eps=1e-6,
                   holdout_modulation=holdout)
    srv.calibrate(torch.tensor(cal_a), torch.tensor(cal_u), alpha=0.2, eps=1e-6,
                  holdout_modulation=holdout)
    np.testing.assert_allclose(float(srv.qhat), float(jsrv.qhat), rtol=REL)
    _rel_close(srv.modulation.numpy(), jsrv.modulation)
    out, jout = srv.predict(torch.tensor(new_a)), jsrv.predict(jnp.asarray(new_a))
    assert out["prediction"].shape == (N, NV, NX, NY, T_OUT)
    _rel_close(out["prediction"].numpy(), jout["prediction"])
    _rel_close(out["residual"].numpy(), jout["residual"])
    _rel_close(out["sets"][1].numpy(), jout["sets"][1])
    np.testing.assert_array_equal(out["accept"].numpy(), np.asarray(jout["accept"]))
    # recalibrate moves alpha without a rollout, identically in both
    np.testing.assert_allclose(float(srv.recalibrate(0.5).qhat),
                               float(jsrv.recalibrate(0.5).qhat), rtol=REL)


def test_joint_cp_coverage_counts_match_cppre(setup):
    """The coverage sweep at DEFAULT_ALPHAS over each framework's own
    rollouts and residuals covers the same number of samples."""
    data = setup["data"]
    jsrv, srv = _surrogates(setup, "aer+pre", True)
    j_pre = JPRE_NS(DT, DX, DX, NU)
    res_t = lambda u: ns_momentum_residual_fused(srv.layout_fn(torch.tensor(u)), DT, DX, DX, NU)
    res_j = lambda u: j_pre.residual_momentum(jnp.transpose(jnp.asarray(u), (0, 1, 4, 2, 3)))
    cal, new = data[:N], data[N:]
    jsrv.calibrate(jnp.asarray(cal[..., :T_IN]), jnp.asarray(cal[..., T_IN:]))
    srv.calibrate(cal[..., :T_IN], cal[..., T_IN:])
    ours = pipeline.joint_cp(res_t(cal[..., T_IN:]), srv.predict(cal[..., :T_IN])["residual"],
                             srv.predict(new[..., :T_IN])["residual"], res_t(new[..., T_IN:]),
                             eps=1e-6)
    ref = jpipe.joint_cp(res_j(cal[..., T_IN:]), jsrv.predict(cal[..., :T_IN])["residual"],
                         jsrv.predict(new[..., :T_IN])["residual"], res_j(new[..., T_IN:]),
                         eps=1e-6)
    np.testing.assert_array_equal(ours["alphas"], pipeline.DEFAULT_ALPHAS)
    np.testing.assert_array_equal(np.round(ours["coverage"] * N), np.round(ref["coverage"] * N))
    np.testing.assert_allclose(float(ours["qhat"]), float(ref["qhat"]), rtol=REL)


def test_save_load_round_trip(setup, tmp_path):
    data = setup["data"]
    _, srv = _surrogates(setup, "aer+pre", True)
    srv.calibrate(data[:N, ..., :T_IN], data[:N, ..., T_IN:], alpha=0.25, eps=1e-6)
    prefix = str(tmp_path / "bundle" / "ns_v1")
    srv.save(prefix)
    fresh = FNO2d(T_IN, 1, 3, 3, NV, 4, device="cpu", generator=torch.Generator().manual_seed(99))
    srv2 = CalibratedSurrogate.load(prefix, fresh, srv.residual_fn, fused=True)
    assert srv2.alpha == 0.25 and srv2.score == "aer+pre" and srv2.n_cal == N
    a_new = data[N:, ..., :T_IN]
    o1, o2 = srv.predict(a_new), srv2.predict(a_new)
    assert torch.equal(o1["prediction"], o2["prediction"])
    assert torch.equal(o1["sets"][0], o2["sets"][0])
    assert torch.equal(o1["accept"], o2["accept"])
    assert torch.equal(srv2.recalibrate(0.1).qhat, srv.recalibrate(0.1).qhat)
    with pytest.raises(ValueError):
        CalibratedSurrogate(fresh, srv.residual_fn, step=1, T_out=T_OUT,
                            score="aer+pre").calibrate(data[:N, ..., :T_IN])
