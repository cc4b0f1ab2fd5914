"""Physics-informed training and the differentiable CNS operators of
cppre_torch against cppre: the PI / PISL / combined losses, the K8 PI
operator and its backward route, the PI loss's gradient through an FNO
rollout, `finetune_physics_informed`, `EulerFVRHS` and `CNSResiduals`,
and the `pi_wave` / `pi_advection` drivers end to end.

Weights are drawn by the port from seeds and carried into flax by cppre's
importer (`fno_params_from_torch`, templates from `jax.eval_shape`);
inputs come from numpy seeds. The cppre side of each comparison is jitted.
On the CPU every kernel wrapper takes its plain version, which torch
autograd differentiates; the card's backward of K8 (K8 on the padded
cotangent with the flipped stencil) is held here through its operands
(`_adjoint_operands`) run by the plain forward.

Tolerances:
* the losses: 1e-6 relative; PISL of a field against itself exactly 0;
* the PI operator against `PRE_Wave(boundary=True)` and cppre's
  `fno_chunk_residual(PRE_Wave)`: 1e-6 of max; its gradient on an
  asymmetric stencil against `jax.grad` of cppre's `direct_conv(same=True)`
  1e-6 of max (a sum of at most k^3 products in another order);
* the PI loss's gradient through a 3-step rollout (K4-K7's plain twins
  through `make_fused_train_apply`) against `jax.grad`: the loss 1e-5
  relative, every gradient 1e-4 of its max;
* 2 PI epochs of Adam on one batch against cppre's: the weights 1e-4 of
  the largest weight of each leaf;
* `EulerFVRHS`, `CNSResiduals.mass` and `.momentum`: 1e-5 of max, their
  gradients 1e-5 of max (the RHS's 1 / dx^2 makes its values ~1e4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from cppre.models import FNO2d as JFNO2d
from cppre.ops.convops import direct_conv as jdirect_conv
from cppre.pi import finetune_physics_informed as j_finetune
from cppre.pi import losses as jlosses
from cppre.residuals.wave import PRE_Wave as JPRE_Wave
from cppre.solvers import cns_differentiable as jcns
from cppre.train.rollout import autoregressive_rollout as j_rollout
from cppre.utils import fno_params_from_torch
from cppre_torch.experiments import pi_advection, pi_wave
from cppre_torch.models import FNO2d, make_fused_train_apply
from cppre_torch.ops.kernels import stencil_kernels as sk
from cppre_torch.pi import (StencilOperator, finetune_physics_informed, make_combined_loss,
                            make_pi_loss, make_pisl_loss)
from cppre_torch.pi import train as pi_train
from cppre_torch.pi.losses import fno_chunk_residual
from cppre_torch.residuals import PRE_Wave
from cppre_torch.solvers.cns_differentiable import CNSResiduals, EulerFVRHS
from cppre_torch.train.rollout import autoregressive_rollout

KW = dict(T_in=1, step=1, modes1=3, modes2=3, num_vars=1, width_time=4)
NX, NY, T_OUT = 12, 10, 4
GRAD_STEPS = 3          # the gradient test's rollout: 3 steps, 1 frame left by the crop
DT, DX, C_PI = 0.04, 0.06, 0.5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread (see `tests/test_torch_ops1d.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(seed, shape, scale=1.0, offset=0.0):
    return (offset + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _asym(k, seed):
    """A random stencil with no symmetry on any axis."""
    return _arr(seed, (k, k, k))


@functools.lru_cache(maxsize=None)
def _flax_pair_tree(seed):
    jm = JFNO2d(**KW)
    src = FNO2d(**KW, device="cpu", generator=torch.Generator().manual_seed(seed))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 1, NX, NY, 1), jnp.float32))
    return jm, template, jax.device_get(fno_params_from_torch(src.state_dict(), template))


def _pair(seed):
    """(flax model, template, params, the port's model with the same weights)."""
    jm, template, params = _flax_pair_tree(seed)
    model = FNO2d(**KW, device="cpu", generator=torch.Generator().manual_seed(seed))
    return jm, template, params, model


def _wave_kernel(c=C_PI):
    return np.asarray(PRE_Wave(DT, DX, c=c).D.kernel)


# ---- the losses and the operator ----------------------------------------------

@pytest.mark.parametrize("kind", ["pi", "pisl", "combined"])
def test_pi_losses_match_cppre(kind):
    pred, target = _arr(1, (2, 1, NX, NY, 6)), _arr(2, (2, 1, NX, NY, 6))
    make, jmake = {"pi": (make_pi_loss, jlosses.make_pi_loss),
                   "pisl": (make_pisl_loss, jlosses.make_pisl_loss),
                   "combined": (make_combined_loss, jlosses.make_combined_loss)}[kind]
    ours = make(fno_chunk_residual(StencilOperator(_wave_kernel())))
    ref = jmake(jlosses.fno_chunk_residual(JPRE_Wave(DT, DX, c=C_PI)))
    got = float(ours(torch.tensor(pred), torch.tensor(target)))
    want = float(jax.jit(ref)(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if kind == "pisl":
        assert float(ours(torch.tensor(pred), torch.tensor(pred))) == 0.0


def test_pi_operator_is_pre_wave_on_the_padded_field():
    """The K8 operator on the zero-padded field equals `PRE_Wave(boundary=
    True)`, and through `fno_chunk_residual` cppre's residual closure; it
    has no `boundary=False` route."""
    f = torch.tensor(_arr(3, (2, 7, NX, NY)))
    op, pre = StencilOperator(_wave_kernel()), PRE_Wave(DT, DX, c=C_PI)
    _close(op(f, boundary=True), pre(f, boundary=True), 1e-6)
    with pytest.raises(ValueError, match="boundary=True"):
        op(f, boundary=False)
    field = _arr(4, (2, 1, NX, NY, 6))
    want = jax.jit(jlosses.fno_chunk_residual(JPRE_Wave(DT, DX, c=C_PI)))(jnp.asarray(field))
    _close(fno_chunk_residual(op)(torch.tensor(field)), want, 1e-6)


@pytest.mark.parametrize("k,pad", [(3, 0), (3, 1), (5, 0), (5, 2)])
def test_k8_backward_route(k, pad):
    """K8's backward on an asymmetric stencil (the wave kernel is symmetric
    on every axis, so a backward that forgot the flip would pass on it):
    the operands the card launches K8 on, run by the plain forward, equal
    the plain twin's autograd (`fused_stencil_residual_bwd_plain`) and
    `jax.grad` of cppre's `direct_conv` (same=True for pad k // 2, the PI
    operator; valid for pad 0)."""
    kern = _asym(k, 5 + k)
    f = _arr(6, (2, 8, 11, 9))
    out_shape = (2,) + tuple(n + 2 * pad - k + 1 for n in f.shape[1:])
    g = _arr(7, out_shape)
    same = pad == k // 2
    want = jax.jit(jax.grad(lambda x: jnp.sum(jnp.asarray(g) * jdirect_conv(
        x, kern, same=same))))(jnp.asarray(f))
    card = sk.fused_stencil_residual_plain(*sk._adjoint_operands(torch.tensor(g), kern, pad))
    _close(card, want, 1e-6)
    _close(sk.fused_stencil_residual_bwd(torch.tensor(g), kern, pad), want, 1e-6)
    ft = torch.tensor(f, requires_grad=True)
    out = (sk.fused_stencil_same(ft, kern) if same else sk.fused_stencil_residual(ft, kern))
    (grad,) = torch.autograd.grad(out, ft, torch.tensor(g))
    _close(grad, want, 1e-6)


def test_k8_take_abs_has_no_gradient():
    f = torch.tensor(_arr(8, (1, 5, 6, 7)), requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        sk.fused_stencil_residual(f, _wave_kernel(), take_abs=True)
    with torch.no_grad():
        sk.fused_stencil_residual(f, _wave_kernel(), take_abs=True)


# ---- the PI loss through an FNO rollout -----------------------------------------

def _jax_pi_loss(jm, a, kernel_c=C_PI):
    loss = jlosses.make_pi_loss(jlosses.fno_chunk_residual(JPRE_Wave(DT, DX, c=kernel_c)))
    return lambda p: loss(j_rollout(lambda x: jm.apply(p, x), a, 1, GRAD_STEPS))


def test_pi_loss_gradient_through_the_rollout_matches_jax():
    """The loss sits only at the end of the rollout: its gradient reaches
    the weights through the autoregressive carry, i.e. through the input
    gradient each fused block's backward returns."""
    jm, template, params, model = _pair(0)
    a = _arr(9, (2, 1, NX, NY, 1), 0.5, 0.5)
    lj, gj = jax.jit(jax.value_and_grad(_jax_pi_loss(jm, jnp.asarray(a))))(params)
    loss = make_pi_loss(fno_chunk_residual(StencilOperator(_wave_kernel())))
    apply_fn = make_fused_train_apply(model)
    lt = loss(autoregressive_rollout(lambda x: checkpoint(apply_fn, x, use_reentrant=False),
                                     torch.tensor(a), 1, GRAD_STEPS))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    grads = fno_params_from_torch({k: p.grad for k, p in model.named_parameters()}, template)
    for got, want in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(gj)):
        _close(np.asarray(got), np.asarray(want), 1e-4)


def test_finetune_matches_cppre():
    """Two epochs of Adam with batch_size == n_train (one batch, so the
    permutation changes only the order of the batch's samples); the first
    epoch's loss is the loss of the starting weights."""
    jm, template, params, model = _pair(1)
    a = _arr(10, (3, 1, NX, NY, 1), 0.5, 0.5)
    u = _arr(11, (3, 1, NX, NY, T_OUT), 0.5, 0.5)
    jloss = jlosses.make_pi_loss(jlosses.fno_chunk_residual(JPRE_Wave(DT, DX, c=C_PI)))
    want = j_finetune(jm.apply, params, jnp.asarray(a), jnp.asarray(u), loss_fn=jloss,
                      epochs=2, batch_size=3, step=1, T_out=T_OUT, lr=1e-3)
    loss = make_pi_loss(fno_chunk_residual(StencilOperator(_wave_kernel())))
    with torch.no_grad():
        l0 = float(loss(autoregressive_rollout(model, torch.tensor(a), 1, T_OUT)))
    state, losses = finetune_physics_informed(
        make_fused_train_apply(model), model, torch.tensor(a), torch.tensor(u), loss_fn=loss,
        epochs=2, batch_size=3, step=1, T_out=T_OUT, lr=1e-3)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], l0, rtol=1e-5)
    got = fno_params_from_torch(state, template)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(np.asarray(g), np.asarray(w), 1e-4)
    moved = fno_params_from_torch(FNO2d(**KW, device="cpu", generator=torch.Generator()
                                        .manual_seed(1)).state_dict(), template)
    assert any(not np.array_equal(np.asarray(g), np.asarray(m)) for g, m in
               zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(moved)))


def test_finetune_refuses_last_chunk_below_three_frames():
    model = FNO2d(**KW, device="cpu", generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    a, u = torch.zeros(2, 1, NX, NY, 1), torch.zeros(2, 1, NX, NY, T_OUT)
    with pytest.raises(ValueError, match="step >= 3"):
        finetune_physics_informed(model, model, a, u, loss_fn=lambda p, t: p.sum(), epochs=1,
                                  batch_size=2, step=2, T_out=T_OUT, loss_on="last")
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_lbfgs_takes_one_update_a_batch(monkeypatch):
    """optax.lbfgs(learning_rate=1.0) as torch's L-BFGS with max_iter=1: one
    update a batch (torch's default max_iter=20 would take up to twenty),
    and the PI loss falls."""
    made = []

    class Counted(torch.optim.LBFGS):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(pi_train.torch.optim, "LBFGS", Counted)
    model = FNO2d(**KW, device="cpu", generator=torch.Generator().manual_seed(3))
    a = torch.tensor(_arr(12, (4, 1, NX, NY, 1), 0.5, 0.5))
    loss = make_pi_loss(fno_chunk_residual(StencilOperator(_wave_kernel())))
    with torch.no_grad():
        l0 = float(loss(autoregressive_rollout(model, a, 1, T_OUT)))
    finetune_physics_informed(model, model, a, a.repeat(1, 1, 1, 1, T_OUT), loss_fn=loss,
                              epochs=2, batch_size=2, step=1, T_out=T_OUT,
                              optimizer="LBFGS")
    (opt,) = made
    group = opt.param_groups[0]
    assert (group["lr"], group["max_iter"], group["history_size"],
            group["line_search_fn"]) == (1.0, 1, 10, "strong_wolfe")
    assert opt.state[opt._params[0]]["n_iter"] == 4           # 2 epochs x 2 batches
    with torch.no_grad():
        assert float(loss(autoregressive_rollout(model, a, 1, T_OUT))) < l0


# ---- the differentiable CNS operators ----------------------------------------------

def _cns_fields(seed, shape):
    f = _arr(seed, shape, 0.1)
    f[:, 0] += 1.0          # density and pressure away from 0
    f[:, 3] += 1.0
    return f


def test_euler_rhs_and_its_gradient_match_cppre():
    f = _cns_fields(13, (2, 4, 12, 10))
    rhs_j = jcns.EulerFVRHS(0.05, 0.05)
    want = jax.jit(rhs_j)(jnp.asarray(f))
    gj = jax.jit(jax.grad(lambda x: jnp.sum(rhs_j(x) ** 2)))(jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    got = EulerFVRHS(0.05, 0.05)(ft)
    _close(got, want, 1e-5)
    (got ** 2).sum().backward()
    _close(ft.grad, gj, 1e-5)


@pytest.mark.parametrize("form", ["mass", "momentum"])
def test_cns_residuals_and_their_gradients_match_cppre(form):
    f = _cns_fields(14, (2, 4, 5, 12, 10))
    eta_zeta = {"eta": 0.01, "zeta": 0.02}
    rj, rt = jcns.CNSResiduals(0.05, 0.01, 0.01), CNSResiduals(0.05, 0.01, 0.01)
    fj = (lambda x: rj.mass(x)) if form == "mass" else (lambda x: rj.momentum(x, eta_zeta))
    ft_fn = (lambda x: rt.mass(x)) if form == "mass" else (lambda x: rt.momentum(x, eta_zeta))
    want = jax.jit(fj)(jnp.asarray(f))
    gj = jax.jit(jax.grad(lambda x: jnp.sum(fj(x) ** 2)))(jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    got = ft_fn(ft)
    _close(got, want, 1e-5)
    (got ** 2).sum().backward()
    _close(ft.grad, gj, 1e-5)


# ---- the drivers end to end ---------------------------------------------------------

KEYS = {"mse_before", "mse_after", "pre_before", "pre_after", "model", "pi_losses"}
NUMBERS = KEYS - {"model", "pi_losses"}


def test_pi_wave_end_to_end():
    """One run (the combined loss); the losses themselves are held against
    cppre's above."""
    out = pi_wave.run("combined", "finetune", config={
        "Nx": 16, "n_train": 4, "n_test": 4, "T_out": 4, "Width_time": 4, "Modes": 3,
        "Epochs": 1, "PI_Epochs": 3}, verbose=False, device="cpu")
    assert set(out) == KEYS and isinstance(out["model"], FNO2d)
    assert all(np.isfinite(out[k]) for k in NUMBERS)
    assert len(out["pi_losses"]) == 3 and np.all(np.isfinite(out["pi_losses"]))
    assert out["pre_after"] < out["pre_before"]


def test_pi_advection_end_to_end():
    out = pi_advection.run("basic", config={
        "Nx": 32, "Nt": 24, "n_train": 4, "n_test": 4, "T_out": 8, "Width": 4, "Modes": 3,
        "PI_Epochs": 3, "Batch Size": 2}, verbose=False, device="cpu")
    assert set(out) == KEYS
    assert all(np.isfinite(out[k]) for k in NUMBERS)
    assert len(out["pi_losses"]) == 3 and out["pi_losses"][-1] < out["pi_losses"][0]
    assert out["pre_after"] < out["pre_before"]
