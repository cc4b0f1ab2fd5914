"""The training half of cppre_torch against cppre: losses, the backward
kernels' plain versions (K6, K7), the fused training apply, the optimizer,
the train step and fit.

Inputs are made with numpy from seeds; weights are drawn by the port from a
seed and carried into flax by cppre's own importer
(`cppre.utils.fno_params_from_torch`). JAX functions that reach a Pallas
kernel run it in interpret mode. Tiny shapes: width 4, modes 3, a 12x10
grid (not a multiple of 8, not square), batch <= 3, V <= 2, T_out <= 4.
Tolerances, each the JAX package's own for the same pair:
* losses: 1e-6 relative (float32 norms in another order);
* K6 plain: 2e-4 of max|ref| (tests/test_pallas_kernels.py:739-742);
* K7 plain: 3e-4 of max|ref| (:786-790);
* fused training apply: loss 1e-4 relative, grads 5e-4 of max|g| (:700-706);
* optimizer: 1e-6 relative on the parameters after 3 steps;
* train step: loss and full-trajectory loss 1e-4 relative.
The interpret-mode JAX reference of the fused training apply takes ~15 s
to compile on a CPU whatever the shape; one module fixture computes it for
both the gradient and the train-step tests.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import cppre.train.losses as jlosses
from cppre.models import FNO2d as JFNO2d
from cppre.models.fused import _bias_branch, _fused_block_bwd, _fused_projection_bwd
from cppre.models.fused import make_fused_train_apply as j_make_fused_train_apply
from cppre.train import loops as jloops
from cppre.utils import fno_params_from_torch
from cppre_torch.models import FNO2d, make_fused_train_apply
from cppre_torch.models.fno import get_grid
from cppre_torch.ops import kernels as K
from cppre_torch.ops.kernels.fno_block import _unpack_spectral
from cppre_torch.train import losses
from cppre_torch.train.loops import fit, make_optimizer, make_train_step, rollout_loss

NV, WIDTH, NX, NY = 2, 4, 12, 10


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(t_in=1, step=1, modes=3, seed=0):
    """(flax model, flax params, the port's model on the CPU with the same
    weights)."""
    model = FNO2d(t_in, step, modes, modes, NV, WIDTH, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    jm = JFNO2d(T_in=t_in, step=step, modes1=modes, modes2=modes, num_vars=NV, width_time=WIDTH)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, NV, NX, NY, t_in), jnp.float32))
    params = jax.device_get(fno_params_from_torch(model.state_dict(), template))
    return jm, params, model


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _port_tree(model, template):
    """The port's .grad of every parameter as a flax params tree."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    return fno_params_from_torch(grads, template)


# ---- losses ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lp_sum", "lp_mean", "lp_p1", "LpLoss", "mse", "mae", "nll",
                                  "elbo"])
def test_losses_match_cppre(name):
    r = _rng(1)
    a, b, c = (r.standard_normal((3, NV, NX, NY, 4)).astype(np.float32) for _ in range(3))
    ta, tb, tc = map(torch.tensor, (a, b, c))
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    ours, ref = {
        "lp_sum": (lambda: losses.lp_loss(ta, tb), lambda: jlosses.lp_loss(ja, jb)),
        "lp_mean": (lambda: losses.lp_loss(ta, tb, size_average=True),
                    lambda: jlosses.lp_loss(ja, jb, size_average=True)),
        "lp_p1": (lambda: losses.lp_loss(ta, tb, p=1), lambda: jlosses.lp_loss(ja, jb, p=1)),
        "LpLoss": (lambda: losses.LpLoss(size_average=False)(ta, tb),
                   lambda: jlosses.LpLoss(size_average=False)(ja, jb)),
        "mse": (lambda: losses.mse(ta, tb), lambda: jlosses.mse(ja, jb)),
        "mae": (lambda: losses.mae(ta, tb), lambda: jlosses.mae(ja, jb)),
        "nll": (lambda: losses.nll(ta, 0.1 * tb, tc), lambda: jlosses.nll(ja, 0.1 * jb, jc)),
        "elbo": (lambda: losses.elbo(ta[0, 0, 0], tb[0, 0, 0], 3),
                 lambda: jlosses.elbo(ja[0, 0, 0], jb[0, 0, 0], 3)),
    }[name]
    np.testing.assert_allclose(np.asarray(ours()), np.asarray(ref()), rtol=1e-6)


# ---- K6 and K7 plain versions -------------------------------------------------

@pytest.fixture(scope="module")
def block_case():
    """One block (f2) of a width-4 model, B=3 and V=2 (the cross-batch and
    cross-variable sums), on the 12x10 grid: port and flax inputs."""
    jm, params, model = _pair(seed=2)
    r = _rng(3)
    z = r.standard_normal((3, WIDTH, NV, NX, NY)).astype(np.float32)
    g = r.standard_normal(z.shape).astype(np.float32)
    grid_c = get_grid((1, NV, NX, NY), "cpu").permute(0, 4, 1, 2, 3)
    bp = params["params"]["f2"]
    x3 = np.asarray(_bias_branch(bp, jnp.asarray(grid_c.numpy())))
    return model.f2, bp, z, g, x3


@pytest.mark.parametrize("ref_impl", ["pallas", "xla"])
def test_block_bwd_plain_matches_cppre(block_case, ref_impl):
    """All ten outputs of `fno_block2d_bwd_plain` against cppre's backward
    rule: the Pallas kernel in interpret mode (through `_bwd_grads_to_tree`,
    with its own 8-row padding of the 12-row grid), and jax.vjp of the
    flax block math."""
    blk, bp, z, g, x3 = block_case
    dx, dwr, dwi, da1, db1, da2, db2, daw, dbw, dx3 = K.fno_block2d_bwd_plain(
        torch.tensor(z), torch.tensor(g), blk, torch.tensor(x3), 3, 3)
    jdx, jg, jdx3 = _fused_block_bwd(3, 3, True, ref_impl,
                                     (jnp.asarray(z), bp, jnp.asarray(x3)), jnp.asarray(g))
    rel = 2e-4
    _close(dx, jdx, rel, "dx")
    _close(dx3, jdx3, rel, "dx3")
    w1, w2 = _unpack_spectral(dwr, dwi, 3)
    sp = jg["SpectralConv2d_0"]
    for got, key in ((w1.real, "weights1_re"), (w1.imag, "weights1_im"),
                     (w2.real, "weights2_re"), (w2.imag, "weights2_im")):
        _close(got, sp[key], rel, key)
    for (wgt, bias), (mod, layer) in (((da1, db1), ("_ChannelMLP_0", "Dense_0")),
                                      ((da2, db2), ("_ChannelMLP_0", "Dense_1")),
                                      ((daw, dbw), ("_Channel1x1_0", "Dense_0"))):
        _close(wgt.T, jg[mod][layer]["kernel"], rel, f"{mod}.{layer}.kernel")
        _close(bias, jg[mod][layer]["bias"], rel, f"{mod}.{layer}.bias")


@pytest.mark.parametrize("ref_impl", ["pallas", "xla"])
def test_projection_bwd_plain_matches_cppre(ref_impl):
    """`projection2d_bwd_plain` against cppre's head backward: the Pallas
    kernel in interpret mode (Ny = 10 padded to 16 by cppre itself) and
    jax.vjp of `_projection_xla`."""
    _, params, model = _pair(step=2, seed=4)
    p = params["params"]
    r = _rng(5)
    z = r.standard_normal((3, NV, NX, NY, WIDTH)).astype(np.float32)
    g = r.standard_normal((3, NV, NX, NY, 2)).astype(np.float32)
    dz, da1, db1, da2, db2 = K.projection2d_bwd_plain(torch.tensor(z), torch.tensor(g),
                                                      model.fc1_time, model.fc2_time)
    jz, jf1, jf2 = _fused_projection_bwd(True, ref_impl, (jnp.asarray(z), p["fc1_time"],
                                                           p["fc2_time"]), jnp.asarray(g))
    for got, ref, what in ((dz, jz, "dz"), (da1.T, jf1["kernel"], "fc1.kernel"),
                           (db1, jf1["bias"], "fc1.bias"), (da2.T, jf2["kernel"], "fc2.kernel"),
                           (db2, jf2["bias"], "fc2.bias")):
        _close(got, ref, 3e-4, what)


# ---- make_fused_train_apply -----------------------------------------------------

@pytest.fixture(scope="module")
def rollout_case():
    """cppre's fused training apply (Pallas forward in interpret mode)
    through a 2-chunk remat rollout (T_in=2, step=2, T_out=4) under
    jax.value_and_grad with the relative L2 loss: the loss, the predicted
    trajectory and the flax grads, and the inputs. These are the values
    cppre's `train_step` computes before its optimizer update."""
    jm, params, _ = _pair(t_in=2, step=2, seed=8)
    r = _rng(9)
    x = r.standard_normal((3, NV, NX, NY, 2)).astype(np.float32)
    y = r.standard_normal((3, NV, NX, NY, 4)).astype(np.float32)
    apply = j_make_fused_train_apply(jm, interpret=True, bwd_impl="xla")
    (lj, pred), gj = jax.value_and_grad(
        lambda v: jloops.rollout_loss(apply, v, jnp.asarray(x), jnp.asarray(y), 2, 4,
                                      jlosses.lp_loss), has_aux=True)(params)
    full = float(jlosses.lp_loss(pred, jnp.asarray(y)))
    return params, x, y, float(lj), full, jax.device_get(gj)


def _rollout_model():
    return FNO2d(2, 2, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(8))


def test_fused_train_apply_matches_cppre(rollout_case):
    """The loss and every parameter gradient (the complex spectral weights'
    as d/dRe + i d/dIm, mapped onto flax's _re/_im leaves) agree with
    jax.value_and_grad of cppre's fused training apply."""
    params, x, y, lj, _, gj = rollout_case
    model = _rollout_model()
    loss, _ = rollout_loss(make_fused_train_apply(model), torch.tensor(x),
                           torch.tensor(y), 2, 4, losses.lp_loss)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), lj, rtol=1e-4)
    ours = jax.tree_util.tree_leaves(_port_tree(model, params))
    ref = jax.tree_util.tree_leaves(gj)
    scale = max(np.abs(np.asarray(v)).max() for v in ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=5e-4 * scale)


# ---- optimizer, train step, fit ---------------------------------------------------

def test_optimizer_matches_optax_chain():
    """3 steps of the port's optimizer against optax's clip -> adam(staircase
    decay) from the same parameters and gradients: steps_per_epoch=2 and
    scheduler_step=1 put the decay at step 3; the first and last gradients
    exceed the clip norm, the second does not."""
    r = _rng(10)
    real = r.standard_normal((3, 4)).astype(np.float32)
    cplx = (r.standard_normal((2, 3)) + 1j * r.standard_normal((2, 3))).astype(np.complex64)
    bias = r.standard_normal(5).astype(np.float32)
    scales = (3.0, 0.05, 5.0)
    grads = [[s * r.standard_normal(a.shape).astype(np.float32) for a in (real, bias)]
             + [s * (r.standard_normal(cplx.shape)
                     + 1j * r.standard_normal(cplx.shape)).astype(np.complex64)]
             for s in scales]
    ps = [torch.nn.Parameter(torch.tensor(v)) for v in (real, bias, cplx)]
    opt = make_optimizer(ps, 5e-3, scheduler_step=1, scheduler_gamma=0.5, steps_per_epoch=2)
    tx = jloops.make_optimizer(5e-3, scheduler_step=1, scheduler_gamma=0.5, steps_per_epoch=2)
    jp = {"real": jnp.asarray(real), "bias": jnp.asarray(bias), "re": jnp.asarray(cplx.real),
          "im": jnp.asarray(cplx.imag)}
    state = tx.init(jp)
    for g in grads:
        for p, gv in zip(ps, g):
            p.grad = torch.tensor(gv)
        opt.step()
        jg = {"real": jnp.asarray(g[0]), "bias": jnp.asarray(g[1]),
              "re": jnp.asarray(g[2].real), "im": jnp.asarray(g[2].imag)}
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
    for got, ref in ((ps[0], jp["real"]), (ps[1], jp["bias"]), (ps[2].real, jp["re"]),
                     (ps[2].imag, jp["im"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_train_step_matches_cppre(rollout_case):
    """One AR train step through the fused apply from the same weights and
    batch as cppre's: the chunk-summed loss and the full-trajectory loss
    (cppre's `train_step` returns these, computed before its update)."""
    _, x, y, lj, full_j, _ = rollout_case
    model = _rollout_model()
    step = make_train_step(make_fused_train_apply(model), make_optimizer(model.parameters(), 5e-3),
                           2, 4, losses.lp_loss)
    loss, full = step(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(loss), lj, rtol=1e-4)
    np.testing.assert_allclose(float(full), full_j, rtol=1e-4)


def test_fit_two_epochs_lowers_the_loss():
    model = FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu",
                  generator=torch.Generator().manual_seed(13))
    r = _rng(14)
    t = np.linspace(0, 1, 4)
    base = np.sin(2 * np.pi * np.linspace(0, 1, NX))[:, None, None] * np.exp(-t)  # [NX, 1, 4]
    amp = r.uniform(0.5, 1.5, (10, NV, 1, 1, 1))
    data = torch.tensor((amp * base + 0.01 * r.standard_normal(
        (10, NV, NX, NY, 4))).astype(np.float32))
    a, u = data[..., :1], data[..., 1:]
    state, hist = fit(make_fused_train_apply(model), model, a, u, a[-2:], u[-2:], epochs=2,
                      batch_size=2, step=1, T_out=3, loss_func=losses.lp_loss, lr=5e-3)
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert hist[1][0] < hist[0][0]
    assert set(state) == set(model.state_dict())
