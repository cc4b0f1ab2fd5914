"""The UQ comparison harness of cppre_torch against cppre: FNO2d dropout,
the Bayesian head, the KL, SWAG's moments, the validators, the MLE and
Bayesian training losses, `evaluate_uq_methods`, `run_eval.run` and the
YAML configs.

Weights are drawn by the port from seeds, carried into flax by cppre's
importer (`fno_params_from_torch`, templates from `jax.eval_shape`) and
back into fresh port models by `fno2d_from_jax` and `fno2d_bayes_from_jax`;
inputs come from numpy seeds.
Random draws (dropout masks, Bayes eps, SWAG's z) cannot agree across
packages: the deterministic parts are held exactly, the stochastic parts
given the same injected draws or by their statistics.

Tolerances:
* forwards (dropout model at eval, the Bayesian head with log_sigma -> -inf
  and with injected eps, the head through K5's route): 1e-5 of max|cppre|;
* `bayes_kl_loss`: 1e-6 relative;
* `validation_mle`, `validation_ensemble`, `validation_aer`,
  `validation_pre` (means, variances, std, qhat): 1e-5 of max|cppre|;
  mse, mae 1e-5 relative;
* SWAG's theta, theta_sq and deviation columns, unflattened into named
  parameters: 1e-6 of max;
* one MLE step's loss and the Bayesian loss with injected eps against
  `jax.value_and_grad`: loss 1e-5 relative, every gradient 1e-4 of its max;
* `evaluate_uq_methods` (Deterministic, AER, PRE, MLE, Ensemble) on the same
  bootstrap draws: l2's mean and std within 1e-5 of the mean, coverage and joint coverage within
  2e-3 (a score at the quantile may flip a cell, as in `tests/test_uq.py`);
* `load_config`: equal to `yaml.safe_load`.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cppre.models import FNO2d as JFNO2d
from cppre.models import variants as jvariants
from cppre.models.swag import SWAG as JSWAG
from cppre.residuals.wave import PRE_Wave as JPRE_Wave
from cppre.uq import eval as jeval
from cppre.uq import train as jtrain
from cppre.uq import validation as jV
from cppre.utils import fno_params_from_torch
from cppre_torch.models import FNO2d, make_fused_apply, make_fused_train_apply
from cppre_torch.models import variants
from cppre_torch.models.fno import dropout
from cppre_torch.models.swag import SWAG
from cppre_torch.residuals import PRE_Wave
from cppre_torch.uq import eval as teval
from cppre_torch.uq import train as ttrain
from cppre_torch.uq import validation as V
from cppre_torch.uq import data_loaders
from cppre_torch.uq.data_loaders import KernelPRE
from cppre_torch.utils import fno2d_bayes_from_jax, fno2d_from_jax, load_config

KW = dict(T_in=1, step=1, modes1=4, modes2=4, num_vars=1, width_time=8)
T_OUT = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread (see `tests/test_torch_ops1d.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _flax(jm, tm, x):
    """The port's weights as jm's flax tree, through cppre's importer (its
    template from `jax.eval_shape`, so no flax init is compiled)."""
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    return jax.device_get(fno_params_from_torch(tm.state_dict(), template))


# a template input: the flax trees' shapes do not depend on the batch
_X = np.zeros((1, 1, 16, 16, 1), np.float32)


@functools.lru_cache(maxsize=None)
def _flax_tree(seed, make, port, extra):
    """(flax model, its params): weights drawn by the port from `seed` and
    carried into flax, once a module (no test writes to the tree)."""
    jm = make(**KW, **dict(extra))
    src = port(**KW, **dict(extra), device="cpu", generator=torch.Generator().manual_seed(seed))
    return jm, _flax(jm, src, _X)


def _pair(seed, make=JFNO2d, port=FNO2d, **extra):
    """(flax model, its params, the port's model): the weights of
    `_flax_tree`, carried back into a fresh port model by
    `fno2d_from_jax`."""
    jm, p = _flax_tree(seed, make, port, tuple(sorted(extra.items())))
    return jm, p, fno2d_from_jax(p, port(**KW, **extra, device="cpu"))


def test_dropout_model_at_eval_matches_cppre():
    x = _arr(0, (2, 1, 16, 16, 1))
    jm, p, tm = _pair(0, dropout_rate=0.5)
    want = jax.jit(jm.apply)(p, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want, 1e-5)
    for refuse in (make_fused_apply, make_fused_train_apply):
        with pytest.raises(ValueError, match="dropout-free"):
            refuse(tm)
    with pytest.raises(ValueError, match="torch.Generator"):
        tm(torch.from_numpy(x), deterministic=False)


def test_dropout_rate_and_scaling():
    p, g = 0.3, torch.Generator().manual_seed(0)
    y = dropout(torch.ones(200_000), p, deterministic=False, generator=g)
    kept = y[y != 0]
    assert torch.all(kept == np.float32(1.0) / np.float32(1 - p))
    # the dropped share is Binomial(n, p): within 5 sigma
    assert abs(float((y == 0).float().mean()) - p) < 5 * math.sqrt(p * (1 - p) / y.numel())
    assert torch.equal(dropout(torch.ones(5), p, deterministic=True), torch.ones(5))
    # MC dropout: live masks vary the forward; a sample's masks repeat
    tm = variants.make_dropout_fno(**KW, dropout_rate=0.5, device="cpu",
                                   generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_arr(1, (2, 1, 16, 16, 1)))
    with torch.no_grad():
        mc = variants.mc_dropout_apply(tm, x, torch.Generator().manual_seed(2), samples=3)
        assert mc.shape == (3, 2, 1, 16, 16, 1) and float(mc.std(dim=0).mean()) > 0
        g = torch.Generator().manual_seed(3)
        same, state = V._DropoutForward(tm, g), g.get_state()
        assert torch.equal(same(x, state), same(x, state))


@functools.lru_cache(maxsize=None)
def _bayes_tree(log_sigma=None):
    """(cppre's FNO2dBayesian, its params): the port draws the weights
    (log_sigma perturbed around log(0.1), or all `log_sigma`), the body
    reaches flax through cppre's importer, the head as the transposes of mu
    and log_sigma; `fno2d_bayes_from_jax` carries the tree back exactly.
    Once a module (no test writes to the tree)."""
    src = variants.FNO2dBayesian(**KW, device="cpu", generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for name, q in src.named_parameters():
            if name.endswith("log_sigma"):
                q.add_(0.3 * torch.randn(q.shape, generator=torch.Generator().manual_seed(5)))
                if log_sigma is not None:
                    q.fill_(log_sigma)
    plain = FNO2d(**KW, device="cpu")
    body = {k: v for k, v in src.state_dict().items() if not k.startswith(("fc1", "fc2"))}
    plain.load_state_dict(body, strict=False)
    p = _flax(JFNO2d(**KW), plain, _X)
    for name in ("fc1_time", "fc2_time"):
        layer = getattr(src, name)
        p["params"][name] = {k: getattr(layer, k).detach().numpy().T
                             for k in ("weight_mu", "weight_log_sigma", "bias_mu",
                                       "bias_log_sigma")}
    tm = fno2d_bayes_from_jax(p, variants.FNO2dBayesian(**KW, device="cpu"))
    for k, v in src.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k
    return jvariants.FNO2dBayesian(**KW), p


def _bayes_pair(log_sigma=None):
    """(cppre's FNO2dBayesian, its params, the port's, fresh)."""
    jm, p = _bayes_tree(log_sigma)
    return jm, p, fno2d_bayes_from_jax(p, variants.FNO2dBayesian(**KW, device="cpu"))


def _drawn_flax_tree(p, eps):
    """cppre's FNO2d tree with the Bayesian head drawn at `eps` (port
    layouts [out, in] transposed to flax's [in, out])."""
    tree = {k: v for k, v in p["params"].items() if k not in ("fc1_time", "fc2_time")}
    for name in ("fc1_time", "fc2_time"):
        q = p["params"][name]
        ew, eb = (jnp.asarray(e.numpy() if isinstance(e, torch.Tensor) else e)
                  for e in eps[name])
        tree[name] = {"kernel": q["weight_mu"] + jnp.exp(q["weight_log_sigma"]) * ew.T,
                      "bias": q["bias_mu"] + jnp.exp(q["bias_log_sigma"]) * eb}
    return {"params": tree}


def test_bayesian_forward_matches_cppre():
    x = _arr(6, (2, 1, 16, 16, 1))
    # log_sigma -> -inf: every draw is the mean, in both packages
    jm, p, tm = _bayes_pair(log_sigma=-np.inf)
    want = jax.jit(lambda p, x: jm.apply(p, x, rngs={"bayes": jax.random.PRNGKey(9)}))(p, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(9))
    _close(got, want, 1e-5)
    # injected eps: the port's draw against cppre's FNO2d with that head
    jm, p, tm = _bayes_pair()
    eps = ttrain._draw_eps(tm, torch.Generator().manual_seed(10))
    want = jax.jit(JFNO2d(**KW).apply)(_drawn_flax_tree(p, eps), x)
    with torch.no_grad():
        head = tm.sample_head(eps=eps)
        _close(tm(torch.from_numpy(x), head=head), want, 1e-5)
        # K5's route (its plain version on the CPU) takes the same head
        _close(make_fused_apply(tm, head=head)(torch.from_numpy(x)), want, 1e-5)
    with pytest.raises(ValueError, match="sample_head"):
        make_fused_apply(tm)
    # the KL over every mu / log_sigma pair
    want_kl = jvariants.bayes_kl_loss(p["params"])
    np.testing.assert_allclose(float(variants.bayes_kl_loss(tm).detach()), float(want_kl),
                               rtol=1e-6)
    np.testing.assert_allclose(float(variants.bayes_kl_loss(tm, reduction="sum").detach()),
                               float(jvariants.bayes_kl_loss(p["params"], reduction="sum")),
                               rtol=1e-6)


class _WaveRes:
    """cppre's PRE_Wave over [B, 1, Nt, Nx, Ny] fields, as `tests/test_uq.py` wraps it."""

    def __init__(self):
        self.pre = JPRE_Wave(0.1, 0.1)

    def residual(self, fields):
        return self.pre(fields[:, 0])


def _data(n=5):
    return _arr(11, (n, 1, 16, 16, 1)), _arr(12, (n, 1, 16, 16, T_OUT))


def test_validators_match_cppre():
    a, u = _data()
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    jm, p1, m1 = _pair(0)
    _, p2, m2 = _pair(1)

    want = jax.jit(lambda a, u: jV.validation_ensemble(jm, [p1, p2], a, u, 1, T_OUT))(a, u)
    for g, w in zip(V.validation_ensemble([m1, m2], ta, tu, 1, T_OUT), want):
        _close(g, w, 1e-5)
    want = jax.jit(lambda a, u: jV.validation_aer(jm, p1, a, u, 1, T_OUT, 0.2))(a, u)
    for g, w in zip(V.validation_aer(m1, ta, tu, 1, T_OUT, 0.2), want):
        _close(g, w, 1e-5)
    want = jax.jit(lambda a, u: jV.validation_pre(jm, p1, a, u, 1, T_OUT, 0.2, _WaveRes()))(a, u)
    for g, w in zip(V.validation_pre(m1, ta, tu, 1, T_OUT, 0.2, PRE_Wave(0.1, 0.1)), want):
        _close(g, w, 1e-5)

    jmle, pm, mle = _pair(2, make=jvariants.make_mle_fno, port=variants.make_mle_fno)
    want = jax.jit(lambda a, u: jV.validation_mle(jmle, pm, a, u, 1, T_OUT))(a, u)
    for g, w in zip(V.validation_mle(mle, ta, tu, 1, T_OUT), want):
        _close(g, w, 1e-5)


def test_stochastic_validators_run_and_restore():
    a, u = _data(3)
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    _, _, bayes = _bayes_pair()
    mean, std, mse, mae = V.validation_bayesian(bayes, ta, tu, 1, T_OUT, 3,
                                                torch.Generator().manual_seed(0))
    assert mean.shape == tu.shape and float(std.mean()) > 0
    drop = variants.make_dropout_fno(**KW, dropout_rate=0.2, device="cpu")
    mean, std, _, _ = V.validation_dropout(drop, ta, tu, 1, T_OUT, 3,
                                           torch.Generator().manual_seed(0))
    assert float(std.mean()) > 0
    _, _, base = _pair(0)
    swag = SWAG(base)
    for s in range(3):
        with torch.no_grad():
            for q in base.parameters():
                q.add_(0.01 * s)
        swag.collect_model(base)
    before = swag.flatten(base)
    mean, std, _, _ = V.validation_swag(base, swag, ta, tu, 1, T_OUT, 3,
                                        torch.Generator().manual_seed(0))
    assert float(std.mean()) > 0 and torch.equal(swag.flatten(base), before)


def test_swag_moments_match_cppre(tmp_path):
    x = _arr(0, (1, 1, 16, 16, 1))
    jm = JFNO2d(**KW)
    trees = [_flax(jm, FNO2d(**KW, device="cpu", generator=torch.Generator().manual_seed(k)), x)
             for k in range(4)]
    jswag = JSWAG(trees[0], max_num_models=3)
    tswag = SWAG(FNO2d(**KW, device="cpu"), max_num_models=3)
    for t in trees:
        jswag.collect_model(t)
        tswag.collect_model(fno2d_from_jax(t, FNO2d(**KW, device="cpu")))
    assert tswag.D.shape == jswag.D.shape == (tswag.dim, 3)

    def named(vec_j):   # cppre's flat vector -> the port's named parameters
        return fno2d_from_jax(jax.device_get(jswag._unravel(jnp.asarray(vec_j))),
                              FNO2d(**KW, device="cpu")).state_dict()

    pairs = [(tswag.theta, jswag.theta), (tswag.theta_sq, jswag.theta_sq)] + \
        [(tswag.D[:, k], jswag.D[:, k]) for k in range(3)]
    for ours, theirs in pairs:
        want = named(theirs)
        for name, value in tswag.unflatten(ours).items():
            _close(torch.view_as_real(value) if value.is_complex() else value,
                   np.asarray(torch.view_as_real(want[name]) if want[name].is_complex()
                              else want[name]), 1e-6)
    # scale 0 draws theta; a draw is a set of named parameters; save / load
    np.testing.assert_array_equal(tswag.sample_vector(torch.Generator().manual_seed(0),
                                                      scale=0.0).numpy(),
                                  tswag.theta.numpy())
    assert set(tswag.sample(torch.Generator().manual_seed(0))) == \
        set(dict(FNO2d(**KW, device="cpu").named_parameters()))
    tswag.save(str(tmp_path / "swag.npz"))
    back = SWAG(FNO2d(**KW, device="cpu")).load(str(tmp_path / "swag.npz"))
    assert torch.equal(back.D, tswag.D) and back.n_models == tswag.n_models == 3


def test_mle_step_matches_jax_value_and_grad():
    a, u = _data()
    jmle, pm, model = _pair(2, make=jvariants.make_mle_fno, port=variants.make_mle_fno)

    def loss_of(p):     # cppre's make_mle_train_step loss, without remat
        def body(carry, y):
            x, acc = carry
            out = jmle.apply(p, x)
            return (jnp.concatenate((x[..., 1:], out[..., :1]), axis=-1),
                    acc + jtrain.nll_chunk_loss(out, y)), None

        return jax.lax.scan(body, (a, 0.0), jnp.moveaxis(u, -1, 0)[..., None])[0][1]

    loss, grads = jax.device_get(jax.jit(jax.value_and_grad(loss_of))(pm))
    ours = ttrain.mle_rollout_loss(make_fused_train_apply(model), torch.from_numpy(a),
                                   torch.from_numpy(u), 1, T_OUT)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(loss), rtol=1e-5)
    want = fno2d_from_jax(grads, variants.make_mle_fno(**KW, device="cpu")).state_dict()
    for name, q in model.named_parameters():
        g = torch.view_as_real(q.grad) if q.grad.is_complex() else q.grad
        w = torch.view_as_real(want[name]) if want[name].is_complex() else want[name]
        _close(g, w.numpy(), 1e-4)
    # the train step takes one optimizer step on that loss
    opt = ttrain.make_optimizer(model.parameters(), 1e-3)
    step = ttrain.make_mle_train_step(make_fused_train_apply(model), opt, 1, T_OUT)
    np.testing.assert_allclose(float(step(torch.from_numpy(a), torch.from_numpy(u))),
                               float(loss), rtol=1e-5)


def test_bayesian_loss_matches_jax_value_and_grad():
    a, u = _data()
    jm, p, tm = _bayes_pair()
    g = torch.Generator().manual_seed(20)
    eps = [ttrain._draw_eps(tm, g) for _ in range(T_OUT)]
    body = JFNO2d(**KW)

    stacked = {name: tuple(np.stack([np.asarray(e[name][i]) for e in eps]) for i in range(2))
               for name in ("fc1_time", "fc2_time")}

    def loss_of(p):     # cppre's make_bayesian_train_step loss at these draws
        kl = jvariants.bayes_kl_loss(p["params"])

        def step(carry, inp):
            y, e = inp
            x, acc = carry
            im = body.apply(_drawn_flax_tree(p, e), x)
            return (jnp.concatenate((x[..., 1:], im), axis=-1),
                    acc + (-(-jnp.sum((im - y) ** 2) - kl) / a.shape[0])), None

        ys = jnp.moveaxis(u, -1, 0)[..., None]
        return jax.lax.scan(step, (a, 0.0), (ys, stacked))[0][1]

    loss, grads = jax.device_get(jax.jit(jax.value_and_grad(loss_of))(p))
    ours = ttrain.bayesian_rollout_loss(make_fused_train_apply(tm), tm, torch.from_numpy(a),
                                        torch.from_numpy(u), 1, T_OUT, eps)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(loss), rtol=1e-5)
    want = fno2d_bayes_from_jax(grads, variants.FNO2dBayesian(**KW, device="cpu")).state_dict()
    for name, q in tm.named_parameters():
        gq = torch.view_as_real(q.grad) if q.grad.is_complex() else q.grad
        w = torch.view_as_real(want[name]) if want[name].is_complex() else want[name]
        _close(gq, w.numpy(), 1e-4)


def test_evaluate_uq_methods_matches_cppre():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 1, 16, 16, 1)).astype(np.float32)
    u = rng.standard_normal((7, 1, 16, 16, T_OUT)).astype(np.float32)
    jm, p1, m1 = _pair(0)
    _, p2, m2 = _pair(1)
    jmle, pm, mle = _pair(2, make=jvariants.make_mle_fno, port=variants.make_mle_fno)
    jfac = {"Ensemble": (jm, [p1, p2]), "MLE": (jmle, pm)}
    tfac = {"Ensemble": (m1, [m1, m2]), "MLE": (mle, None)}
    methods = ["Deterministic", "AER", "PRE", "MLE", "Ensemble"]
    kw = dict(methods=methods, test_a=a, test_u=u, step=1, T_out=T_OUT, runs=2, n_eval=5,
              samples=2, verbose=False)
    want = jeval.evaluate_uq_methods(model_factory=lambda m: jfac.get(m, (jm, p1)),
                                     pre=_WaveRes(), **kw)
    banked = []
    got = teval.evaluate_uq_methods(model_factory=lambda m: tfac.get(m, (m1, None)),
                                    pre=PRE_Wave(0.1, 0.1),
                                    on_method_done=lambda m, r: banked.append(m), **kw)
    assert banked == methods
    for m in methods:
        # l2 is (mean, std) over the resamples: the std of two close values
        # cancels, so it is held to the mean's 1e-5
        np.testing.assert_allclose(got[m]["l2"], want[m]["l2"], rtol=0,
                                   atol=1e-5 * want[m]["l2"][0], err_msg=m)
        for stat in ("coverage", "joint_coverage"):
            np.testing.assert_allclose(got[m][stat], want[m][stat], atol=2e-3,
                                       err_msg=f"{m}.{stat}")
    # batch_chunk is a memory knob: the same statistics in pieces 3, 3, 1
    chunked = teval.evaluate_uq_methods(model_factory=lambda m: tfac.get(m, (m1, None)),
                                        pre=PRE_Wave(0.1, 0.1), batch_chunk=3,
                                        **dict(kw, n_eval=7))
    full = teval.evaluate_uq_methods(model_factory=lambda m: tfac.get(m, (m1, None)),
                                     pre=PRE_Wave(0.1, 0.1), **dict(kw, n_eval=7))
    for m in methods:
        np.testing.assert_allclose(chunked[m]["l2"], full[m]["l2"], rtol=0,
                                   atol=1e-5 * full[m]["l2"][0], err_msg=m)
    with pytest.raises(ValueError, match="exclusive"):
        teval.evaluate_uq_methods(model_factory=None, mesh=object(), batch_chunk=3, **kw)


def test_run_eval_wave_end_to_end():
    """`run_eval.run("Wave")` at `tests/test_uq.py`'s tiny overrides, with
    `Train Precision` at "highest"; a name that is not a precision is
    refused (the others run in tests/test_torch_train_options.py); a case
    simulated beforehand (`case_data`) gives the same run."""
    from cppre_torch.uq.run_eval import run

    ov = {"UQ": ["Deterministic", "PRE", "MLE"], "Epochs": 1, "n_total": 6,
          "n_train_eval": 3, "runs": 1, "n_eval": 2, "samples": 1, "Batch Size": 3,
          "T_out": 4, "Modes": 4, "Width_time": 8}
    res = run("Wave", overrides=ov, verbose=False, device="cpu")
    assert set(res) == {"Deterministic", "PRE", "MLE"}
    for r in res.values():
        assert np.isfinite(r["l2"][0]) and 0 <= r["coverage"][0] <= 1
    # the case simulated once and passed in gives the same run
    sim = data_loaders.load_wave("in", n=ov["n_total"], seed=0, device="cpu")
    again = run("Wave", overrides=dict(ov, UQ=["Deterministic"]), verbose=False, device="cpu",
                case_data=sim)
    assert again["Deterministic"]["l2"] == res["Deterministic"]["l2"]
    with pytest.raises(ValueError, match="unknown precision"):
        run("Wave", overrides=dict(ov, **{"Train Precision": "fp8"}), verbose=False,
            device="cpu", case_data=sim)


def test_kernel_pre_takes_the_plain_class_on_the_cpu():
    """On a CPU tensor the loaders' PREs take their kernels' plain versions,
    equal to the plain classes (the wave and MHD energy bit for bit, the NS
    momentum to rounding, 1e-6 of max); boundary=True is the class's own."""
    f = torch.from_numpy(_arr(13, (2, 6, 5, 9, 8)))
    for routed, fields, rel in ((data_loaders._ns_pre(0.1, 0.1, 0.1), f, 1e-6),
                                (data_loaders._mhd_pre(0.1, 0.1), f, 0.0),
                                (data_loaders._wave_pre(0.1, 0.1, 1.0), f[:, :1], 0.0)):
        assert isinstance(routed, KernelPRE)
        if rel:
            _close(routed(fields), routed.pre.residual(fields), rel)
        else:
            assert torch.equal(routed(fields), routed.pre.residual(fields))
        assert torch.equal(routed.residual(fields, boundary=True),
                           routed.pre.residual(fields, boundary=True))


def test_load_config_equals_yaml(tmp_path):
    import glob
    import os

    import cppre_torch

    root = os.path.join(os.path.dirname(cppre_torch.__file__), "uq", "configs")
    paths = sorted(glob.glob(os.path.join(root, "*_FNO.yaml")))
    assert [os.path.basename(q) for q in paths] == ["MHD_FNO.yaml", "NS_FNO.yaml",
                                                    "Wave_FNO.yaml"]
    for q in paths:
        with open(q) as f:
            assert load_config(q) == yaml.safe_load(f), q
    odd = tmp_path / "odd.yaml"
    odd.write_text("# comment\nA key: 'x # not a comment'  # comment\nB: [1, 2.5, 'c', true]\n"
                   "C: {u: 1, v: 'w'}\nD: 1e-3\nE: 5.0e-3\nF: ~\nG: -7\nH: \"q\"\n")
    with open(odd) as f:
        assert load_config(str(odd)) == yaml.safe_load(f)
    nested = tmp_path / "nested.yaml"
    nested.write_text("A:\n  b: 1\n")
    with pytest.raises(ValueError, match="flat mapping"):
        load_config(str(nested))
