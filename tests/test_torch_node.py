"""The neural-ODE studies in the port (`cppre_torch.node`) against cppre.

Inputs are made with numpy from seeds; the vector field's weights are
cppre's flax init, carried into the port by `utils.odefunc_from_jax`, so
both packages integrate the same network on the CPU.

Tolerances:
* closed forms and `_trajectories`: bit for bit (the same float64 numpy);
  the composite kernels bit for bit, their residuals 1e-6 of max|cppre|;
* `neural_odeint`: 1e-5 of max|y| against `cppre.node.neural_odeint`
  (the same Dormand-Prince steps and dense output; float32 rounding of
  another order of sums can move a step's accept decision, which the
  dense output absorbs at the tolerance);
* a batched family against the port's per-sample loop: 1e-6 of max|y|;
* gradients: backprop through the accepted steps against cppre's adjoint
  ODE, 1e-3 of each gradient's max (both solve to rtol = atol = 1.4e-8;
  measured 2-4e-6);
* `fit_node`, 3 epochs from the same weights: the losses 1e-4 relative,
  the weights 1e-4 of each tensor's max (measured 1e-5);
* `run` at Nt 40, 3 epochs, from cppre's init: mse 1e-3 relative, qhat 1e-3
  of its max, coverage within one cell in a hundred, the round trip
  1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.ode import odeint as j_odeint

from cppre import node as J
from cppre.node import experiments as jexp
from cppre.node import problems as jprob
from cppre_torch import node as T
from cppre_torch.node import experiments as texp
from cppre_torch.node import models as tmodels
from cppre_torch.node import problems as tprob
from cppre_torch.utils import odefunc_from_jax

FIT_TOL = dict(rtol=1.4e-8, atol=1.4e-8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(time_dependent, seed=0, y0=np.zeros(2, np.float32)):
    """cppre's ODEFunc and its init params at `seed`, and the port's with
    the same weights."""
    jm = J.ODEFunc(hidden_dim=50, state_dim=2, time_dependent=time_dependent)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros(()), jnp.asarray(y0)))
    return jm, params, odefunc_from_jax(params, T.ODEFunc(50, 2, time_dependent, device="cpu"))


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


# ---- problems ----------------------------------------------------------------------------

def test_closed_forms_and_families_bit_for_bit():
    t = np.linspace(0.5, 12, 40)
    for name, kw in (("sho_solution", dict(x0=1.3, v0=-0.2, k=2.0)),
                     ("dho_solution", dict(x0=0.8, v0=0.3, c=0.7)),
                     ("bessel_solution", dict(order=1)),
                     ("cauchy_euler_solution", dict(a=1.0, b=1.0, c1=0.7, c2=0.2)),
                     ("cauchy_euler_solution", dict(a=4.0, b=1.0, c1=0.7, c2=0.2)),
                     ("cauchy_euler_solution", dict(a=3.0, b=1.0, c1=0.7, c2=0.2)),
                     ("bessel_state", dict(amp=1.2)), ("cauchy_euler_state", dict(c1=0.9))):
        np.testing.assert_array_equal(getattr(tprob, name)(t, **kw), getattr(jprob, name)(t, **kw))
    for problem in texp.PROBLEMS:
        tt = texp._domain(problem, 30, None)
        np.testing.assert_array_equal(tt, jexp._domain(problem, 30, None))
        np.testing.assert_array_equal(texp._trajectories(problem, 5, tt, 3),
                                      jexp._trajectories(problem, 5, tt, 3))


def test_residuals_match_cppre():
    r = np.random.default_rng(0)
    t = np.linspace(0.5, 12, 40).astype(np.float32)
    y = r.standard_normal((3, 40)).astype(np.float32)
    for make in ("sho_residual_kernel", "dho_residual_kernel"):
        D, jD = getattr(T, make)(0.1), getattr(J, make)(0.1)
        np.testing.assert_array_equal(D.kernel, jD.kernel)
        _close(D(torch.tensor(y)), jD(jnp.asarray(y)), 1e-6)
    for name, kw in (("bessel_residual", {}), ("bessel_residual", dict(order=2)),
                     ("cauchy_euler_residual", dict(a=2.0, b=0.75))):
        ref = jax.vmap(lambda v: getattr(jprob, name)(v, t, **kw))(jnp.asarray(y))
        _close(getattr(tprob, name)(torch.tensor(y), t, **kw), ref, 1e-6)
        _close(getattr(tprob, name)(y[0], t, **kw), ref[0], 1e-6)


# ---- the integrator ----------------------------------------------------------------------

@pytest.mark.parametrize("time_dependent", [False, True])
def test_neural_odeint_matches_cppre(time_dependent):
    jm, params, model = _pair(time_dependent)
    t = np.linspace(0.5, 10, 40).astype(np.float32)
    y0 = np.array([1.0, 0.2], np.float32)
    _close(T.neural_odeint(model, y0, t), J.neural_odeint(jm, params, y0, t), 1e-5)
    ref = j_odeint(lambda y, tt: jm.apply(params, tt, y), jnp.asarray(y0), jnp.asarray(t))
    _close(T.neural_odeint(model, y0, t, **FIT_TOL), ref, 1e-5)


@pytest.mark.parametrize("time_dependent", [False, True])
def test_batched_family_equals_the_per_sample_loop(time_dependent):
    _, _, model = _pair(time_dependent, seed=1)
    t = np.linspace(1.0, 8.0, 30).astype(np.float32)
    y0 = np.random.default_rng(2).uniform(-1.5, 1.5, (6, 2)).astype(np.float32)
    with torch.no_grad():
        fam, stats = T.neural_odeint(model, y0, t, return_stats=True)
        loop = [T.neural_odeint(model, y, t, return_stats=True) for y in y0]
    _close(fam, torch.stack([ys for ys, _ in loop]), 1e-6)
    # each sample kept its own steps: the counts of the loop, sample by sample
    for k in ("accepted", "rejected"):
        assert stats[k].tolist() == [int(s[k][0]) for _, s in loop]
    assert len(set(stats["accepted"].tolist())) > 1


def test_odeint_is_jax_odeint_on_a_linear_system():
    """An explicit linear field, no network: dy/dt = A y, both solvers at
    their defaults, against each other and the matrix exponential."""
    A = np.array([[0.0, 1.0], [-4.0, -0.3]], np.float32)
    t = np.linspace(0, 3, 25).astype(np.float32)
    y0 = np.array([1.0, 0.0], np.float32)
    ref = j_odeint(lambda y, tt: jnp.asarray(A) @ y, jnp.asarray(y0), jnp.asarray(t))
    At = torch.tensor(A)
    ours = tmodels.odeint(lambda y, tt: y @ At.T, torch.tensor(y0)[None], t)[0]
    _close(ours, ref, 1e-5)
    w, V = np.linalg.eig(A.astype(np.float64))
    exact = np.stack([(V @ np.diag(np.exp(w * s)) @ np.linalg.solve(V, y0)).real for s in t])
    _close(ours, exact, 1e-5)


def test_fixed_steps_give_the_adaptive_result():
    """`fixed_steps` (the loop a CUDA graph holds in `fit_node` on the card)
    runs a set number of steps with the finished samples masked: at least
    the adaptive loop's steps give its values bit for bit; fewer leave the
    samples "unfinished"."""
    _, _, model = _pair(True, seed=3)
    t = np.linspace(1.0, 6.0, 20).astype(np.float32)
    y0 = torch.tensor(np.random.default_rng(4).uniform(-1, 1, (3, 2)).astype(np.float32))
    f = lambda y, tt: model(tt, y)
    with torch.no_grad():
        ref, stats = tmodels.odeint(f, y0, t, return_stats=True)
        n = int((stats["accepted"] + stats["rejected"]).max())
        got, fixed = tmodels.odeint(f, y0, t, return_stats=True, fixed_steps=n + 7)
        _, short = tmodels.odeint(f, y0, t, return_stats=True, fixed_steps=n // 2)
    assert torch.equal(got, ref) and not bool(stats["unfinished"].any())
    assert torch.equal(fixed["accepted"], stats["accepted"]) and not bool(fixed["unfinished"].any())
    assert bool(short["unfinished"].all())


@pytest.mark.parametrize("time_dependent", [False, True])
def test_backprop_gradient_matches_cppre_adjoint(time_dependent):
    problem = "bessel" if time_dependent else "sho"
    t = texp._domain(problem, 40, None)
    target = texp._trajectories(problem, 1, t, 0)[0]
    jm, params, model = _pair(time_dependent, y0=target[0])

    def loss(p):
        traj = j_odeint(lambda y, tt: jm.apply(p, tt, y), jnp.asarray(target[0]), jnp.asarray(t))
        return jnp.mean((traj - target) ** 2)

    jloss, jgrad = jax.jit(jax.value_and_grad(loss))(params)
    traj = T.neural_odeint(model, target[0], t, **FIT_TOL)
    ours = torch.mean((traj - torch.tensor(target)) ** 2)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(jloss), rtol=1e-5)
    for i, layer in enumerate(model.layers()):
        g = jgrad["params"][f"Dense_{i}"]
        _close(layer.weight.grad, np.asarray(g["kernel"]).T, 1e-3)
        _close(layer.bias.grad, g["bias"], 1e-3)


def _init_as_cppre(model, params):
    """Make `model.reset_parameters` (fit_node's init) load cppre's params."""
    model.reset_parameters = lambda generator=None: odefunc_from_jax(params, model)
    return model


def test_fit_node_matches_cppre():
    t = texp._domain("sho", 40, None)
    target = texp._trajectories("sho", 1, t, 0)[0]
    jm, params, model = _pair(False, y0=target[0])
    trained = J.fit_node(jm, target[0], t, target, epochs=3, seed=0)
    state, losses = T.fit_node(_init_as_cppre(model, params), target[0], t, target, epochs=3)
    assert len(losses) == 3 and losses[-1] < losses[0]
    # the first loss is the initial weights' (cppre's value, computed apart)
    traj0 = j_odeint(lambda y, tt: jm.apply(params, tt, y), jnp.asarray(target[0]),
                     jnp.asarray(t))
    np.testing.assert_allclose(losses[0], float(jnp.mean((traj0 - target) ** 2)), rtol=1e-4)
    for i in range(3):
        p = trained["params"][f"Dense_{i}"]
        _close(state[f"dense{i}.weight"], np.asarray(p["kernel"]).T, 1e-4)
        _close(state[f"dense{i}.bias"], p["bias"], 1e-4)
    # fit_node's own init draws flax's distribution from a torch generator
    fresh = T.ODEFunc(50, 2, device="cpu")
    T.fit_node(fresh, target[0], t, target, epochs=0, seed=4)
    w = fresh.dense1.weight.detach().numpy()
    assert np.all(fresh.dense1.bias.detach().numpy() == 0)
    assert abs(w.std() * np.sqrt(50) - 1.0) < 0.1 and np.abs(w).max() <= 2 / 0.8796 / np.sqrt(50)
    again = T.ODEFunc(50, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    assert torch.equal(again.dense1.weight, fresh.dense1.weight)


# ---- the drivers -------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["sho", "bessel"])
def test_run_matches_cppre(problem, monkeypatch):
    """`run` at Nt 40 and 3 epochs, the port's fit starting from cppre's
    init (the converted weights)."""
    kw = dict(n_train=1, n_cal=24, n_pred=10, Nt=40, epochs=3, alpha=0.1, seed=0,
              verbose=False)

    def fit_from_cppre(model, y0, t, target, *, epochs, seed, verbose):
        _, params, _ = _pair(model.time_dependent, seed=seed, y0=y0)
        return T.fit_node(_init_as_cppre(model, params), y0, t, target, epochs=epochs)

    monkeypatch.setattr(texp, "fit_node", fit_from_cppre)
    # cppre's rollout loop compiles `odeint` anew for every sample (~0.5 s
    # each: `closure_convert` makes a new function per call); the same
    # solve jitted once per model gives the same trajectories
    jitted = {}

    def neural_odeint_once(model, params, y0, t, rtol=1e-6, atol=1e-7):
        if model not in jitted:
            jitted[model] = jax.jit(lambda p, y, tt: j_odeint(
                lambda s, u: model.apply(p, u, s), y, tt, rtol=rtol, atol=atol))
        return jitted[model](params, jnp.asarray(y0, jnp.float32), jnp.asarray(t, jnp.float32))

    monkeypatch.setattr(jexp, "neural_odeint", neural_odeint_once)
    ours = texp.run(problem, device="cpu", **kw)
    ref = jexp.run(problem, **kw)
    np.testing.assert_allclose(ours["mse"], ref["mse"], rtol=1e-3)
    _close(ours["qhat"], ref["qhat"], 1e-3)
    assert ours["qhat"].shape == ref["qhat"].shape == (40 - (4 if problem == "sho" else 6),)
    assert abs(ours["coverage"] - ref["coverage"]) <= 0.01
    np.testing.assert_allclose(ours["roundtrip_err"], ref["roundtrip_err"], rtol=1e-4)
    assert ours["steps"]["accepted"] > 34 and len(ours["fit_losses"]) == 3
    assert isinstance(ours["model"], T.ODEFunc)


def test_node_all_and_problems_match_cppre():
    assert T.__all__ == J.__all__ and texp.__all__ == jexp.__all__
    assert texp.PROBLEMS == jexp.PROBLEMS
    with pytest.raises(ValueError, match="unknown problem"):
        texp.run("vdp", device="cpu")
