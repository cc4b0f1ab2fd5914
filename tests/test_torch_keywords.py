"""cppre's route keywords in the port: `run_2d_cp(fused_forward=...,
fused_train=...)` and `make_fused_train_apply(model, bwd_impl=...)`.

The port defaults to the kernels (fused_forward and fused_train True, where
cppre defaults to False); the values carry cppre's meaning: False sends the
rollouts through `FNO2d`'s own forward and the training through plain
autograd, and bwd_impl='xla' differentiates the block and head math in place
of K6 and K7. Inputs are made with numpy from seeds; weights are drawn by
the port from the seed `run_2d_cp` uses and carried into flax by cppre's own
importer. Tolerances, those of `tests/test_torch_ns.py`'s `run_2d_cp`
pairing: qhat 1e-4 of its max, the joint coverage counts and the filter mask
equal, mse 1e-4 relative (two epochs of Adam add float32 rounding of
another summation order, ~1e-6 relative, to the weights); the bwd_impl
gradients 1e-4 of each gradient's max (the same plain math on the CPU).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import base2d as jbase2d
from cppre.models import FNO2d as JFNO2d
from cppre.models import fused as jfused
from cppre.residuals.ns import PRE_NS as JPRE_NS
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import base2d
from cppre_torch.models import FNO2d, fused, make_fused_train_apply
from cppre_torch.residuals import PRE_NS
from cppre_torch.utils import fno2d_from_jax

DT, DX, NU = 0.01, 0.01, 1e-3
CFG = {"T_in": 1, "T_out": 3, "Step": 1, "n_train": 0, "n_cal": 8, "n_pred": 8, "Modes": 3,
       "Variables": 3, "Width_time": 4, "Normalisation Strategy": "Min-Max"}
TRAIN_CFG = dict(CFG, n_train=4, n_cal=6, n_pred=6, Epochs=2, **{
    "Batch Size": 4, "Learning Rate": 1e-3, "Scheduler Step": 100, "Scheduler Gamma": 0.5})


def _ns_like_data(n=16, nx=12, ny=10, nt=4, seed=0):
    """Smooth-plus-noise NS-like fields [n, 3, Nx, Ny, Nt]."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx)[:, None, None]
    y = np.linspace(0, 1, ny)[None, :, None]
    t = np.arange(nt)[None, None, :] * 0.1
    amp = rng.uniform(0.5, 1.5, size=(n, 3, 1, 1, 1))
    base = np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) * np.exp(-t)
    return (amp * base + 0.05 * rng.standard_normal((n, 3, nx, ny, nt))).astype(np.float32)


def _flax_params(model, data):
    jm = JFNO2d(T_in=1, step=1, modes1=3, modes2=3, num_vars=3, width_time=4)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,) + data.shape[1:4]
                                                                        + (1,)))
    return jax.device_get(fno_params_from_torch(model.state_dict(), template))


def _assert_cp_matches(ours, ref, n):
    q, jq = np.asarray(ours["qhat"]), np.asarray(ref["qhat"])
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-4 * np.abs(jq).max())
    for key in ("coverage_aer_pre", "coverage_pre", "coverage_aer_pre_holdout",
                "coverage_pre_holdout"):
        np.testing.assert_array_equal(np.round(np.asarray(ours[key]) * n),
                                      np.round(np.asarray(ref[key]) * n), key)
    for key in ("alphas", "filter_mask"):
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(ref[key]), key)
    np.testing.assert_allclose(ours["mse"], ref["mse"], rtol=1e-4)


@pytest.mark.parametrize("fn,keyword", [("run_2d_cp", "fused_forward"),
                                        ("run_2d_cp", "fused_train"),
                                        ("make_fused_train_apply", "bwd_impl")])
def test_cppre_keywords_are_accepted(fn, keyword):
    """Each of cppre's keywords exists in the port, of the same kind; the
    port's run_2d_cp defaults to the kernels where cppre defaults to XLA."""
    ours = inspect.signature(getattr(base2d if fn == "run_2d_cp" else fused, fn))
    theirs = inspect.signature(getattr(jbase2d if fn == "run_2d_cp" else jfused, fn))
    p, q = ours.parameters[keyword], theirs.parameters[keyword]
    assert p.kind == q.kind
    if keyword == "bwd_impl":
        assert p.default == q.default == "pallas"
    else:
        assert q.default is False and p.default is True


def test_run_2d_cp_fused_forward_false_matches_cppre():
    """Rollouts through FNO2d's own forward, weights given: cppre's default
    route, against cppre's."""
    data = _ns_like_data()
    src = FNO2d(1, 1, 3, 3, 3, 4, device="cpu", generator=torch.Generator().manual_seed(3))
    params = _flax_params(src, data)
    state = fno2d_from_jax(params, FNO2d(1, 1, 3, 3, 3, 4, device="cpu")).state_dict()
    ours = base2d.run_2d_cp(data=data, residual_fn=PRE_NS(DT, DX, DX, NU).residual_momentum,
                            cfg=CFG, params=state, fused_forward=False, verbose=False,
                            device="cpu")
    ref = jbase2d.run_2d_cp(data=jnp.asarray(data),
                            residual_fn=JPRE_NS(DT, DX, DX, NU).residual_momentum, cfg=CFG,
                            params=params, fused_forward=False, verbose=False)
    assert ours["apply_fn"] is ours["model"]
    _assert_cp_matches(ours, ref, CFG["n_pred"])


def test_run_2d_cp_fused_train_false_matches_cppre(monkeypatch):
    """Training through plain autograd, two epochs of one batch, from the
    weights the port draws at run_2d_cp's seed (handed to cppre's init),
    then the rollouts through FNO2d's forward: against cppre's run at the
    same seed."""
    data = _ns_like_data()
    seed = 2
    init = FNO2d(1, 1, 3, 3, 3, 4, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = _flax_params(init, data)
    monkeypatch.setattr(JFNO2d, "init", lambda self, *a, **k: params)
    ours = base2d.run_2d_cp(data=data, residual_fn=PRE_NS(DT, DX, DX, NU).residual_momentum,
                            cfg=TRAIN_CFG, seed=seed, fused_forward=False, fused_train=False,
                            verbose=False, device="cpu")
    ref = jbase2d.run_2d_cp(data=jnp.asarray(data),
                            residual_fn=JPRE_NS(DT, DX, DX, NU).residual_momentum,
                            cfg=TRAIN_CFG, seed=seed, fused_forward=False, fused_train=False,
                            verbose=False)
    assert len(ours["train_losses"]) == TRAIN_CFG["Epochs"]
    trained = _flax_params(ours["model"], data)
    for a, b in zip(jax.tree_util.tree_leaves(trained), jax.tree_util.tree_leaves(ref["params"])):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-6))
    _assert_cp_matches(ours, ref, TRAIN_CFG["n_pred"])


def test_bwd_impl_xla_gives_plain_autograd_gradients():
    """bwd_impl='xla' differentiates the plain block and head math: the
    gradients of every parameter and of the input are plain autograd's
    through FNO2d; an unknown bwd_impl is refused by name."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 2, 12, 10, 1)).astype(np.float32))
    model = FNO2d(1, 1, 3, 3, 2, 4, device="cpu", generator=torch.Generator().manual_seed(5))

    def grads(apply_fn):
        model.zero_grad(set_to_none=True)
        xs = x.clone().requires_grad_()
        (apply_fn(xs) ** 2).sum().backward()
        return {"x": xs.grad, **{k: p.grad.clone() for k, p in model.named_parameters()}}

    got, want = grads(make_fused_train_apply(model, bwd_impl="xla")), grads(model)
    assert got.keys() == want.keys()
    for k, g in want.items():
        g, h = torch.view_as_real(g) if g.is_complex() else g, got[k]
        h = torch.view_as_real(h) if h.is_complex() else h
        assert float((h - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
    with pytest.raises(ValueError, match="'triton'"):
        make_fused_train_apply(model, bwd_impl="triton")
