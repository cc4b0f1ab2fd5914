"""cppre's training options in the port: the precision and activation-dtype
scopes (`models.precision_scope`, `with_matmul_precision`,
`activation_dtype_scope`, `with_activation_dtype`), selective
checkpointing (`train.resolve_remat_policy`, `remat_policy=`) and
`train_precision` at the places that refused it before.

Inputs are made with numpy from seeds; weights are drawn by the port and
carried into flax by cppre's own importer. Tiny shapes: width 4, modes 3,
a 12x10 grid, two variables, T_out 3.

Tolerances:
* remat policies against full recomputation and against no checkpoint:
  the loss and every gradient within 1e-6 of its max (a policy changes
  what is saved, never values);
* one bf16 train step (single-shot, T_out 1) against cppre's
  `with_activation_dtype` step from the same weights and batch: the loss
  within 2e-2 relative and the updated
  weights within 2e-2 of each tensor's max. Torch's autocast keeps the
  elementwise glue and the weights float32 where cppre casts everything
  to bf16, so the two round differently at bf16's 8-bit mantissa; the
  float32 loss (the port's, equal to cppre's at 1e-4 in
  tests/test_torch_train.py) differs from either by more than the bf16
  pair does from each other, which the test checks too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.models import FNO2d as JFNO2d
from cppre.models import with_activation_dtype as j_with_activation_dtype
from cppre.train import loops as jloops
from cppre.train.losses import lp_loss as j_lp_loss
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import al_advection, base2d, burgers
from cppre_torch.models import (FNO1d, FNO2d, activation_dtype_scope, make_fused_train_apply,
                                precision_scope, with_activation_dtype, with_matmul_precision,
                                with_train_precision)
from cppre_torch.train.loops import fit, make_optimizer, make_train_step, resolve_remat_policy
from cppre_torch.train.losses import lp_loss

NV, WIDTH, NX, NY, T_OUT = 2, 4, 12, 10, 3
TORCH_NAME = {"highest": "highest", "high": "high", "default": "medium"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags():
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32


def _model(seed=0):
    return FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(seed))


def _batch(seed=1, b=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, NV, NX, NY, 1)).astype(np.float32)
    y = r.standard_normal((b, NV, NX, NY, T_OUT)).astype(np.float32)
    return x, y


def _autocast_cpu():
    return torch.is_autocast_enabled("cpu")


# ---- the scopes -------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_precision_scope_sets_and_restores_the_flags(precision):
    saved = _flags()
    try:
        for start in (("highest", False), ("high", True)):
            torch.set_float32_matmul_precision(start[0])
            torch.backends.cudnn.allow_tf32 = start[1]
            with precision_scope(precision):
                assert _flags() == (TORCH_NAME[precision], precision != "highest")
            assert _flags() == start
            with pytest.raises(RuntimeError, match="inside"):
                with precision_scope(precision):
                    raise RuntimeError("inside")
            assert _flags() == start
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_unknown_precisions_are_refused():
    for call in (lambda: precision_scope("fp8").__enter__(),
                 lambda: with_matmul_precision(lambda x: x, "fp8"),
                 lambda: with_train_precision(lambda x: x, "fp8")):
        with pytest.raises(ValueError, match="unknown precision"):
            call()
    assert with_train_precision(len, "highest") is len


def test_activation_dtype_scope_autocasts_and_restores():
    model = _model()
    x = torch.tensor(_batch()[0])
    with activation_dtype_scope(torch.bfloat16):
        assert _autocast_cpu()
        assert model.fc0_time(torch.cat((x, x, x), dim=-1)).dtype == torch.bfloat16
    assert not _autocast_cpu()
    with pytest.raises(RuntimeError):
        with activation_dtype_scope(torch.bfloat16):
            raise RuntimeError
    assert not _autocast_cpu()
    with activation_dtype_scope(None):
        assert not _autocast_cpu()
    # the wrapped apply: float32 out, float32 weights, bf16-scale agreement
    with torch.no_grad():
        ref, out = model(x), with_activation_dtype(model)(x)
    assert out.dtype == torch.float32
    assert all(p.dtype in (torch.float32, torch.complex64) for p in model.parameters())
    assert float((out - ref).abs().max()) < 5e-2 * float(ref.abs().max())


class _Probe(torch.autograd.Function):
    """Identity that logs the precision state in its forward and backward."""

    @staticmethod
    def forward(ctx, x, log):
        ctx.log = log
        log.append(("fwd", torch.get_float32_matmul_precision(), _autocast_cpu()))
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.log.append(("bwd", torch.get_float32_matmul_precision(), _autocast_cpu()))
        return g, None


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_scoped_train_step_runs_its_backward_in_the_scope(precision):
    """The wrapped apply's train step runs its forward, the checkpoint
    recompute and the backward inside the scope, and restores the flags; a
    wrapper that scoped only its own call would run the backward outside."""
    model = _model()
    x, y = map(torch.tensor, _batch())
    log = []
    apply = lambda z: _Probe.apply(model(z), log)
    want = (("highest", True) if precision == "bf16" else (TORCH_NAME[precision], False))
    before = _flags()
    step = make_train_step(with_train_precision(apply, precision),
                           make_optimizer(model.parameters(), 1e-3), 1, T_OUT, lp_loss)
    loss, full = step(x, y)
    assert np.isfinite(float(loss)) and np.isfinite(float(full))
    assert _flags() == before and not _autocast_cpu()
    kinds = [k for k, *_ in log]
    # T_OUT forwards, their T_OUT recomputes and T_OUT backwards
    assert kinds.count("fwd") == 2 * T_OUT and kinds.count("bwd") == T_OUT
    assert all(tuple(state) == want for _, *state in log), log
    if precision == "high":
        def forward_only(z):
            with precision_scope("high"):
                return apply(z)

        log.clear()
        make_train_step(forward_only, make_optimizer(model.parameters(), 1e-3), 1, T_OUT,
                        lp_loss)(x, y)
        assert {s for k, s, _ in log if k == "bwd"} == {"highest"}


# ---- remat policies ----------------------------------------------------------------------

def test_resolve_remat_policy_names():
    from torch.utils.checkpoint import CheckpointPolicy as P

    aten = torch.ops.aten
    assert resolve_remat_policy(None) is None
    fn = lambda ctx, op, *a, **k: P.PREFER_RECOMPUTE
    assert resolve_remat_policy(fn) is fn
    want = {"dots": (P.MUST_SAVE, P.MUST_SAVE, P.PREFER_RECOMPUTE),
            "dots_no_batch": (P.MUST_SAVE, P.PREFER_RECOMPUTE, P.PREFER_RECOMPUTE),
            "nothing_saveable": (P.PREFER_RECOMPUTE,) * 3,
            "everything_saveable": (P.MUST_SAVE,) * 3}
    for name, jax_name in (("dots", "checkpoint_dots"),
                           ("dots_no_batch", "dots_with_no_batch_dims_saveable"),
                           ("nothing_saveable", None), ("everything_saveable", None)):
        for n in filter(None, (name, jax_name)):
            pol = resolve_remat_policy(n)
            got = tuple(pol(None, op) for op in (aten.mm.default, aten.bmm.default,
                                                 aten.add.Tensor))
            assert got == want[name], n
    for bad in ("offload_dot_with_no_batch_dims", "save_only_these_names", "dot"):
        with pytest.raises(ValueError, match="checkpoint_dots"):
            resolve_remat_policy(bad)
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_train_step(len, None, 1, T_OUT, lp_loss, remat_policy="dot")


def _loss_and_grads(route, remat, policy):
    model = _model(seed=3)
    apply = make_fused_train_apply(model) if route == "fused" else model
    x, y = map(torch.tensor, _batch(seed=4))
    from cppre_torch.train.loops import rollout_loss

    loss, _ = rollout_loss(apply, x, y, 1, T_OUT, lp_loss, remat=remat, remat_policy=policy)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_remat_policies_leave_loss_and_gradients_unchanged(route):
    """Every policy, and no checkpoint at all, against full recomputation:
    the loss and every gradient within 1e-6 of its max. On the CPU the
    fused route takes K4-K7's plain versions, custom autograd Functions
    under the selective checkpoint as on the card."""
    ref_loss, ref = _loss_and_grads(route, True, None)
    calls = []

    def counting(ctx, op, *args, **kwargs):
        calls.append(op)
        return resolve_remat_policy("dots")(ctx, op, *args, **kwargs)

    for remat, policy in ((True, "dots"), (True, "dots_no_batch"), (True, "nothing_saveable"),
                          (True, "everything_saveable"), (True, counting), (False, None)):
        loss, grads = _loss_and_grads(route, remat, policy)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6, err_msg=str(policy))
        for k, g in grads.items():
            scale = float(ref[k].abs().max())
            assert float((g - ref[k]).abs().max()) <= 1e-6 * max(scale, 1e-12), (policy, k)
    # the callable was consulted, and saw the glue's products
    assert torch.ops.aten.mm.default in calls or torch.ops.aten.addmm.default in calls


# ---- bf16 against cppre ------------------------------------------------------------------

def test_bf16_train_step_matches_cppre():
    """One single-shot train step (T_out = step = 1: cppre compiles a
    rollout of any length in ~5 s more)."""
    model = _model(seed=5)
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=NV, width_time=WIDTH)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, NV, NX, NY, 1), jnp.float32))
    params = jax.device_get(fno_params_from_torch(model.state_dict(), template))
    x, y = _batch(seed=6)
    y = y[..., :1]
    lr = 1e-3
    tx = jloops.make_optimizer(lr)
    jstep = jloops.make_train_step(j_with_activation_dtype(jm.apply), tx, 1, 1, j_lp_loss)
    jparams, _, jloss, _ = jstep(params, tx.init(params), jnp.asarray(x), jnp.asarray(y))

    xt, yt = torch.tensor(x), torch.tensor(y)
    f32_loss = float(lp_loss(_model(seed=5)(xt), yt).detach())
    step = make_train_step(with_activation_dtype(model), make_optimizer(model.parameters(), lr),
                           1, 1, lp_loss)
    loss, _ = step(xt, yt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    # the two bf16 steps are nearer each other than either is to float32
    assert abs(float(loss) - float(jloss)) < abs(f32_loss - float(jloss)) + abs(
        f32_loss - float(loss))
    ours = fno_params_from_torch(model.state_dict(), template)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(jparams)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * max(np.abs(b).max(), 1e-6))


# ---- the former refusals ----------------------------------------------------------------

def _ns_like(n=14, seed=0):
    r = np.random.default_rng(seed)
    x = np.linspace(0, 1, NX)[:, None, None]
    yy = np.linspace(0, 1, NY)[None, :, None]
    t = np.arange(T_OUT + 1)[None, None, :] * 0.1
    base = np.sin(2 * np.pi * x) * np.cos(2 * np.pi * yy) * np.exp(-t)
    amp = r.uniform(0.5, 1.5, (n, 3, 1, 1, 1))
    return (amp * base + 0.05 * r.standard_normal((n, 3, NX, NY, T_OUT + 1))).astype(np.float32)


CFG = {"T_in": 1, "T_out": T_OUT, "Step": 1, "n_train": 4, "n_cal": 5, "n_pred": 5, "Modes": 3,
       "Variables": 3, "Width_time": 4, "Epochs": 1, "Batch Size": 2, "Learning Rate": 1e-3,
       "Scheduler Step": 100, "Scheduler Gamma": 0.5}


def _residual(u):
    return u[..., 1:-1, 1:-1, 1:-1] - u[..., :-2, 1:-1, 1:-1]


@pytest.mark.parametrize("precision,fused_train", [("high", True), ("default", True),
                                                   ("bf16", False), ("default", False)])
def test_run_2d_cp_trains_at_each_precision(precision, fused_train):
    before = _flags()
    out = base2d.run_2d_cp(data=_ns_like(), residual_fn=_residual, cfg=CFG, verbose=False,
                           fused_train=fused_train, train_precision=precision, device="cpu")
    assert _flags() == before
    assert np.isfinite(out["train_losses"]).all() and np.isfinite(out["qhat"]).all()
    assert np.isfinite(out["mse"])


def test_bf16_refuses_fused_train():
    with pytest.raises(ValueError, match="bf16"):
        base2d.run_2d_cp(data=_ns_like(), residual_fn=_residual, cfg=CFG, verbose=False,
                         fused_train=True, train_precision="bf16", device="cpu")


def test_fit_takes_a_remat_policy_and_a_precision():
    model = FNO1d(1, 1, 3, 1, 4, device="cpu", generator=torch.Generator().manual_seed(7))
    r = np.random.default_rng(8)
    a = torch.tensor(r.standard_normal((4, 1, 16, 1)).astype(np.float32))
    u = torch.tensor(r.standard_normal((4, 1, 16, T_OUT)).astype(np.float32))
    for policy, precision in (("dots", "highest"), ("dots_no_batch", "bf16")):
        _, hist = fit(with_train_precision(model, precision), model, a, u, a[:2], u[:2],
                      epochs=1, batch_size=2, step=1, T_out=T_OUT, loss_func=lp_loss,
                      remat_policy=policy)
        assert np.isfinite(hist).all()


@pytest.mark.parametrize("site", ["burgers", "al_advection", "al_loop_fno2d"])
def test_other_sites_train_at_a_lower_precision(site):
    before = _flags()
    if site == "burgers":
        out = burgers.run("joint", config={"Nx": 32, "Nt": 6, "n_train": 4, "n_cal": 6,
                                           "n_pred": 4, "T_out": 4, "Width": 4, "Modes": 3,
                                           "Epochs": 1, "Batch Size": 2},
                          verbose=False, train_precision="bf16", device="cpu")
        assert np.isfinite(out["qhat"]).all()
    elif site == "al_advection":
        out = al_advection.run("PRE", config={"Nx": 32, "Nt": 24, "n_train": 4, "n_test": 4,
                                              "n_cal": 6, "n_pred": 6, "T_out": 8, "Width": 4,
                                              "Modes": 3, "Epochs": 1, "n_iterations": 1,
                                              "Batch Size": 2},
                               verbose=False, train_precision="high", device="cpu")
        assert np.all(np.isfinite(out["PRE"]["test_mse"]))
    else:
        from cppre_torch.al import active_learning_loop
        from cppre_torch.al.loop import _applies

        model = _model(seed=9)
        for precision in ("bf16", "default"):
            roll, train = _applies(model, precision)
            assert train.scope is not None and roll is not model
        data = torch.tensor(_ns_like(8, seed=10)[:, :NV])

        def gen(p):
            idx = torch.as_tensor(np.arange(len(p)) % 8)
            return data[idx, ..., :1], data[idx, ..., 1:]

        _, mse, sims = active_learning_loop(
            acq_func="RAND", model=model, gen_fields=gen, residual_of=lambda p: p,
            lb=np.zeros(2), ub=np.ones(2), train_a=data[:4, ..., :1], train_u=data[:4, ..., 1:],
            test_a=data[4:, ..., :1], test_u=data[4:, ..., 1:], n_iterations=1, n_pred=4,
            epochs=1, batch_size=2, T_out=T_OUT, verbose=False, train_precision="bf16")
        assert np.all(np.isfinite(mse)) and sims == [2]
    assert _flags() == before and not _autocast_cpu()


@pytest.mark.parametrize("precision", ["default", "bf16"])
def test_run_eval_trains_at_a_lower_precision(precision):
    from cppre_torch.uq import data_loaders
    from cppre_torch.uq.run_eval import run

    ov = {"UQ": ["Deterministic", "MLE", "Bayesian"], "Epochs": 1, "n_total": 6,
          "n_train_eval": 3, "runs": 1, "n_eval": 2, "samples": 1, "Batch Size": 3, "T_out": 4,
          "Modes": 4, "Width_time": 8, "Train Precision": precision}
    sim = data_loaders.load_wave("in", n=ov["n_total"], seed=0, device="cpu")
    res = run("Wave", overrides=ov, verbose=False, device="cpu", case_data=sim)
    assert set(res) == {"Deterministic", "MLE", "Bayesian"}
    for r in res.values():
        assert np.isfinite(r["l2"][0])
