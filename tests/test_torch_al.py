"""Active learning of cppre_torch against cppre: the four acquisition
functions, `active_learning_loop` as a whole, and the `al_advection` and
`al_more` drivers.

Inputs and candidate pools come from numpy seeds (the LHS design is numpy
in both packages). The loop is held against cppre's on a tiny advection
case with `epochs=0`, so that no training permutation (jax.random in
cppre, a torch.Generator in the port) enters: the same surrogate, carried
from flax into the port by `fno1d_from_jax`, rolls out the same pools,
and both loops acquire, simulate and evaluate. A second run with
`epochs=1` checks the port's loop by its behaviour.

Tolerances:
* acquisition: the same rows, bit for bit;
* the loop at epochs=0: the same `sims_sampled`, `test_mse` at 1e-5
  relative (the port's FNO1d from the carried weights, 1e-5 of max in
  `tests/test_torch_advection.py`);
* `al_more`'s wave residual (K8's plain version on the CPU) against
  `PRE_Wave(boundary=False)`: 1e-6 of max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre import al as jal
from cppre.cp import calibrate as jcalibrate
from cppre.cp.inductive import ncf_metric_joint as jncf
from cppre.experiments import advection as jadv
from cppre.models import FNO1d as JFNO1d
from cppre.residuals.advection import PRE_Advection as JPRE_Advection
from cppre.solvers.advection1d import Advection1D as JAdvection1D
from cppre.train.rollout import validation_AR as j_validation_AR
from cppre.utils import fno_params_from_torch
from cppre_torch import al
from cppre_torch.experiments import advection, al_advection, al_more, wave
from cppre_torch.models import FNO1d, FNO2d
from cppre_torch.residuals import PRE_Advection, PRE_Wave
from cppre_torch.solvers import Advection1D
from cppre_torch.utils import fno1d_from_jax

NX, NT, T_OUT = 32, 24, 8
LB, UB = advection.LB, advection.UB


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread (see `tests/test_torch_ops1d.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- acquisition --------------------------------------------------------------------

def _pool(seed=0, n=20):
    r = np.random.default_rng(seed)
    """(params, residuals, joint scores of residuals drawn alike, modulation,
    marginal scores)."""
    mod = np.abs(r.standard_normal((5, 7))).astype(np.float32) + 1e-6
    scores = np.max(np.abs(r.standard_normal((50, 5, 7))) / mod, axis=(1, 2)).astype(np.float32)
    return (r.random((n, 2)).astype(np.float32), r.standard_normal((n, 5, 7)).astype(np.float32),
            scores, mod, np.abs(r.standard_normal((40, 5, 7))).astype(np.float32))


@pytest.mark.parametrize("name", ["cp", "cp_marginal", "pre_largest", "pre_smallest", "rand"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_acquisition_takes_cppres_rows(name, as_tensor):
    """Every function on the same pool and residuals chooses cppre's rows
    (the residuals as numpy, or as a torch tensor as the loop passes them)."""
    params, res, scores, mod, scores_m = _pool(1)
    r = torch.tensor(res) if as_tensor else res
    got, want = {
        "cp": lambda: (al.acquire_cp(params, r, scores, mod, 0.5),
                       jal.acquire_cp(params, res, scores, mod, 0.5)),
        "cp_marginal": lambda: (al.acquire_cp_marginal(params, r, scores_m, 0.5, 0.4),
                                jal.acquire_cp_marginal(params, res, scores_m, 0.5, 0.4)),
        "pre_largest": lambda: (al.acquire_pre(params, r, 0.5),
                                jal.acquire_pre(params, res, 0.5)),
        "pre_smallest": lambda: (al.acquire_pre(params, r, 0.3, largest=False),
                                 jal.acquire_pre(params, res, 0.3, largest=False)),
        "rand": lambda: (al.acquire_rand(params, 0.5, seed=3),
                         jal.acquire_rand(params, 0.5, seed=3)),
    }[name]()
    assert isinstance(got, np.ndarray) and got.dtype == params.dtype
    np.testing.assert_array_equal(got, np.asarray(want))
    if name == "cp":
        assert 0 < len(got) < len(params)


def test_acquire_cp_marginal_threshold_semantics():
    """A candidate is acquired when its fraction of cells outside
    [-qhat, qhat] reaches the threshold, as in cppre's own test."""
    rng = np.random.default_rng(2)
    params = rng.random((3, 2)).astype(np.float32)
    cal_scores = np.abs(rng.standard_normal((40, 4, 6))).astype(np.float32)
    qhat = np.asarray(jcalibrate(cal_scores, 40, 0.5))
    inside = np.zeros((4, 6), np.float32)
    half = inside.copy()
    half[:2] = qhat[:2] + 1.0
    residual = np.stack([inside, qhat + 1.0, half])
    for threshold, rows in ((0.4, slice(1, 3)), (0.5, slice(1, 3)), (0.6, slice(1, 2))):
        got = al.acquire_cp_marginal(params, residual, cal_scores, 0.5, threshold)
        np.testing.assert_array_equal(got, params[rows])
        np.testing.assert_array_equal(
            got, jal.acquire_cp_marginal(params, residual, cal_scores, 0.5, threshold))


# ---- the loop ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def advection_case():
    """`_advection_case`, made once for the module: the loops below run
    with epochs=0, so nothing changes its models."""
    return _advection_case()


def _advection_case(seed=0):
    """cppre's and the port's pieces of a tiny advection AL case: the flax
    FNO1d from seeded port weights and those weights carried back into the
    port by `fno1d_from_jax`, both solvers and PREs, the initial and test
    designs, and joint and marginal calibration scores from cppre."""
    jm = JFNO1d(T_in=1, step=1, modes1=3, num_vars=1, width_time=4)
    src = FNO1d(1, 1, 3, 1, 4, device="cpu", generator=torch.Generator().manual_seed(seed))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, NX - 3, 1)))
    params = jax.device_get(fno_params_from_torch(src.state_dict(), template))
    model = fno1d_from_jax(params, FNO1d(1, 1, 3, 1, 4, device="cpu"))
    jsim, sim = JAdvection1D(NX, NT, 0.0, 2.0, 0.5), Advection1D(NX, NT, 0.0, 2.0, 0.5,
                                                                  device="cpu")
    jpre, pre = JPRE_Advection(jsim.dt, jsim.dx, 1.0), PRE_Advection(sim.dt, sim.dx, v=1.0)
    jgen = lambda p: jadv._gen_fields(jsim, p, 1, T_OUT)
    gen = lambda p: advection._gen_fields(sim, p, 1, T_OUT)
    designs = {k: advection.sample_params(LB, UB, 4, s) for k, s in (("train", 0), ("test", 9),
                                                                    ("cal", 5))}
    cal_a, cal_u = jgen(designs["cal"])
    pred, _, _ = jax.jit(lambda a, u: j_validation_AR(lambda x: jm.apply(params, x), a, u, 1,
                                                      T_OUT))(cal_a, cal_u)
    rp = jpre(jadv._to_convops(pred))
    # Scores of the prediction's own residual (the acquisition compares the
    # pool's), under one modulation for every cell: at this size the truth's
    # residual is ~10x the untrained surrogate's, so scores of their
    # difference reject no candidate; and with 4 calibration samples the
    # per-cell `modulation_func` is ~0 where the prediction does not depend
    # on the input (the far field), where every score then sits, so that
    # rounding (1e-7 of residual between the packages) would decide.
    rp = np.asarray(rp)
    mod = np.full(rp.shape[1:], np.std(rp), np.float32)
    scores = np.asarray(jncf(rp, np.zeros_like(rp), mod))
    return dict(jm=jm, params=params, model=model, jgen=jgen, gen=gen, jpre=jpre, pre=pre,
                designs=designs, mod=mod, scores=scores, scores_m=np.abs(rp))


KW = dict(lb=LB, ub=UB, n_iterations=2, n_pred=8, alpha=0.5, batch_size=2, step=1,
          T_out=T_OUT, verbose=False)


@pytest.mark.parametrize("acq", ["CP", "PRE"])
def test_loop_matches_cppre_without_training(acq, advection_case):
    case = advection_case
    ja, ju = case["jgen"](case["designs"]["train"])
    jta, jtu = case["jgen"](case["designs"]["test"])
    _, want_mse, want_sims = jal.active_learning_loop(
        acq_func=acq, model=case["jm"], params=case["params"], gen_fields=case["jgen"],
        residual_of=jax.jit(lambda p: case["jpre"](jadv._to_convops(p))),
        train_a=ja, train_u=ju, test_a=jta, test_u=jtu, cal_scores=case["scores"],
        modulation=case["mod"], cal_scores_marginal=case["scores_m"], epochs=0, **KW)
    a, u = case["gen"](case["designs"]["train"])
    ta, tu = case["gen"](case["designs"]["test"])
    state, mse, sims = al.active_learning_loop(
        acq_func=acq, model=case["model"], gen_fields=case["gen"],
        residual_of=lambda p: case["pre"](advection._to_convops(p)),
        train_a=a, train_u=u, test_a=ta, test_u=tu, cal_scores=case["scores"],
        modulation=case["mod"], cal_scores_marginal=case["scores_m"], epochs=0, **KW)
    assert sims == want_sims and len(mse) == 3
    np.testing.assert_allclose(mse, want_mse, rtol=1e-5)
    assert all(torch.equal(v, case["model"].state_dict()[k]) for k, v in state.items())
    assert sims == {"CP": [1, 1], "PRE": [4, 4]}[acq]


def _port_case(seed):
    """The port's model (seeded weights), design generator and PRE alone."""
    sim = Advection1D(NX, NT, 0.0, 2.0, 0.5, device="cpu")
    model = FNO1d(1, 1, 3, 1, 4, device="cpu", generator=torch.Generator().manual_seed(seed))
    gen = lambda p: advection._gen_fields(sim, p, 1, T_OUT)
    a, u = gen(advection.sample_params(LB, UB, 4, 0))
    ta, tu = gen(advection.sample_params(LB, UB, 4, 9))
    pre = PRE_Advection(sim.dt, sim.dx, v=1.0)
    return dict(model=model, gen_fields=gen, residual_of=lambda p: pre(advection._to_convops(p)),
                train_a=a, train_u=u, test_a=ta, test_u=tu)


def test_loop_trains_the_model_in_place():
    case = _port_case(1)
    before = {k: v.clone() for k, v in case["model"].state_dict().items()}
    state, mse, sims = al.active_learning_loop(acq_func="RAND", epochs=1, **case, **KW)
    assert sims == [4, 4] and len(mse) == 3 and np.all(np.isfinite(mse))
    assert any(not torch.equal(before[k], v) for k, v in state.items())


def test_loop_refuses_what_it_cannot_do():
    case = _port_case(0)
    with pytest.raises(ValueError, match="cal_scores_marginal"):
        al.active_learning_loop(acq_func="CP_MARGINAL", epochs=0, **case, **KW)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        al.active_learning_loop(acq_func="PRE", epochs=0, train_precision="bf16", **case, **KW)


# ---- the drivers ----------------------------------------------------------------------

ADV = {"Nx": NX, "Nt": NT, "n_train": 4, "n_test": 4, "n_cal": 6, "n_pred": 6, "T_out": T_OUT,
       "Width": 4, "Modes": 3, "Epochs": 1, "n_iterations": 1, "Batch Size": 2}


def test_al_advection_restores_the_pretrained_weights(monkeypatch):
    """Every acquisition function starts its loop, and so its first
    fine-tune, from the same pretrained weights, as cppre's all start from
    params0."""
    starts, real = [], al_advection.active_learning_loop

    def record(**kw):
        starts.append({k: v.clone() for k, v in kw["model"].state_dict().items()})
        return real(**kw)

    monkeypatch.setattr(al_advection, "active_learning_loop", record)
    out = al_advection.run("all", config=ADV, verbose=False, device="cpu")
    assert set(out) == {"CP", "PRE", "RAND"} and len(starts) == 3
    for s in starts[1:]:
        assert all(torch.equal(s[k], starts[0][k]) for k in s)
    for f, r in out.items():
        assert set(r) == {"test_mse", "sims_sampled", "state_dict"}
        assert len(r["test_mse"]) == 2 and np.all(np.isfinite(r["test_mse"]))
    # PRE and RAND fine-tuned from the same start, on other data: they end apart
    assert any(not torch.equal(out["PRE"]["state_dict"][k], v)
               for k, v in out["RAND"]["state_dict"].items())


@pytest.mark.parametrize("case,acq", [("burgers", "CP"), ("wave", "PRE")])
def test_al_more_end_to_end(case, acq):
    cfg = {"burgers": {"Nx": 32, "Nt": 12, "Width": 4},
           "wave": {"Nx": 16, "Width_time": 4}}[case]
    out = al_more.run(case, acq, config={**cfg, "n_train": 4, "n_test": 4, "n_cal": 6,
                                         "n_pred": 6, "T_out": 4, "Modes": 3, "Epochs": 1,
                                         "n_iterations": 1}, verbose=False, device="cpu")
    assert set(out) == {"test_mse", "sims_sampled", "model"}
    assert isinstance(out["model"], FNO2d if case == "wave" else FNO1d)
    assert len(out["test_mse"]) == 2 and np.all(np.isfinite(out["test_mse"]))
    if acq == "PRE":
        assert out["sims_sampled"] == [3]


def test_al_more_wave_residual_is_pre_wave():
    """The wave case's residual (K8 on the card, its plain version here) is
    `PRE_Wave(boundary=False)` of the FNO-layout prediction."""
    cfg, _, _, _, _, to_res = al_more._setup_wave({"Nx": 16, "Width_time": 4, "Modes": 3}, 0,
                                                   "cpu")
    pred = torch.tensor(_arr(3, (2, 1, 16, 16, 6)))
    sim = wave._sim(cfg, "cpu")
    want = PRE_Wave(sim.dt * cfg["t_slice"], sim.dx, c=cfg["c"])(pred.permute(0, 1, 4, 2, 3))
    np.testing.assert_allclose(to_res(pred).numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
