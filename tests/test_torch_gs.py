"""The Grad-Shafranov family of cppre_torch against cppre: the Solov'ev
data, `PRE_GradShafranov`, the CAE and INR surrogates carried over from
flax, one Adam step of the surrogate training, `run_freegsnke`,
`load_efit_csv` and `run_efit`.

Inputs come from numpy seeds and go through both packages on the CPU.

Tolerances:
* Solov'ev (`solovev_psi`, `gs_forcing`, `solovev_batch`): exact (the same
  numpy code);
* `PRE_GradShafranov`: 1e-6 of max|cppre|, and Delta* against the analytic
  forcing at 1 % (finite-difference truncation), as `tests/test_gs.py` holds
  cppre's operators;
* the CAE and INR forwards from `cae_from_jax` / `inr_from_jax`: 1e-5 of
  max|cppre|, at 64^2 and at an odd grid;
* one Adam step from the same weights and batch against optax: the loss
  at 1e-5 relative, each gradient and each parameter after the step within
  1e-5 of its max;
* `run_freegsnke` (CAE and INR) and `run_efit` at `tests/test_gs.py`'s tiny
  configurations: the marginal coverage diagonal within 0.15 on average,
  and `run_efit`'s coverage within 0.05 below 1 - alpha, as there; on a
  CSV's pairs `run_efit` equals cppre's coverage to 1e-3;
* `load_efit_csv`: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppre.experiments import gs as jgs
from cppre.models.cae import ConvAutoencoder as JCAE
from cppre.models.inr import INR as JINR
from cppre.residuals.gs import PRE_GradShafranov as JPRE_GS
from cppre.solvers import solovev as jsolovev
from cppre_torch.experiments import gs
from cppre_torch.models import INR, ConvAutoencoder
from cppre_torch.ops import ConvOperator2d
from cppre_torch.residuals import PRE_GradShafranov
from cppre_torch.solvers import solovev
from cppre_torch.utils import cae_from_jax, inr_from_jax


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: six test workers' thread pools would otherwise
    spin against each other (see `tests/test_torch_ops1d.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("n,nr,nz,seed", [(3, 64, 64, 0), (2, 33, 17, 5)])
def test_solovev_is_cppre_bit_for_bit(n, nr, nz, seed):
    ours, theirs = solovev.solovev_batch(n, nr, nz, seed=seed), \
        jsolovev.solovev_batch(n, nr, nz, seed=seed)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    R, Z, params, _ = ours
    np.testing.assert_array_equal(solovev.gs_forcing(R, Z, params[0, 0]),
                                  jsolovev.gs_forcing(R, Z, params[0, 0]))
    np.testing.assert_array_equal(solovev.solovev_psi(R, Z, params[1, 0], params[1, 1:]),
                                  jsolovev.solovev_psi(R, Z, params[1, 0], params[1, 1:]))


GS_CASES = {
    "3d": dict(shape=None, kw={}),
    "3d-unscaled-boundary": dict(shape=None, kw=dict(norms=False, boundary=True)),
    "4d-time": dict(shape=(2, 3), kw={}),
    "legacy-y": dict(shape=None, kw={}, legacy=True),
}


@pytest.mark.parametrize("case", list(GS_CASES))
def test_gs_residual_matches_cppre(case):
    c = GS_CASES[case]
    R, Z, _, psi = solovev.solovev_batch(3, 24, 20, seed=2)
    dr, dz = float(R[1] - R[0]), float(Z[1] - Z[0])
    if c["shape"] is not None:   # a real time axis: [BS, Nt, NR, NZ]
        psi = np.stack([psi[:2] * (1 + 0.1 * t) for t in range(3)], axis=1)
    legacy = c.get("legacy", False)
    want = jax.jit(lambda p: JPRE_GS(R, dr, dz, legacy_y_axis=legacy)(p, **c["kw"]))(
        jnp.asarray(psi))
    got = PRE_GradShafranov(R, dr, dz, legacy_y_axis=legacy)(torch.from_numpy(psi), **c["kw"])
    _close(got, want, 1e-6)


def test_delta_star_matches_analytic_forcing():
    """Delta* of the Solov'ev psi through the port's operators equals
    R^2 + A(1 - R^2) to finite-difference truncation."""
    R, Z, params, psi = solovev.solovev_batch(2, 64, 64, seed=0)
    dr, dz = float(R[1] - R[0]), float(Z[1] - Z[0])
    f = torch.from_numpy(psi)[:, None]
    r_col = torch.from_numpy(R)[:, None]
    delta = (ConvOperator2d("x", 2)(f) / dr**2 - (1 / r_col) * ConvOperator2d("x", 1)(f)
             / (2 * dr) + ConvOperator2d("y", 2)(f) / dz**2)[:, 0, 1:-1, 1:-1]
    for i in range(2):
        exp = solovev.gs_forcing(R, Z, params[i, 0])[1:-1, 1:-1]
        assert np.abs(delta[i].numpy() - exp).max() / np.abs(exp).max() < 0.01


def _surrogate_pair(kind, n):
    """(flax model, its params, the port's model with them, coords, params)."""
    rng = np.random.default_rng(n)
    coords = rng.random((2, 2, n, n)).astype(np.float32)
    pf = rng.random((2, 12)).astype(np.float32)
    if kind == "cae":
        jm, tm, load = JCAE(), ConvAutoencoder(grid=(n, n), device="cpu"), cae_from_jax
    else:
        jm = JINR(width=32, depth=2, n_freqs=4)
        tm, load = INR(width=32, depth=2, n_freqs=4, device="cpu"), inr_from_jax
    params = _random_tree(jm, n, coords, pf)
    return jm, params, load(params, tm), coords, pf


def _random_tree(jm, seed, *args):
    """Random flax params of jm's structure (from `jax.eval_shape`, so no
    flax init is compiled): N(0, 1/fan_in) kernels, N(0, 0.1^2) biases."""
    rng = np.random.default_rng(seed)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    scale = lambda s: 0.1 if len(s.shape) == 1 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
    return jax.tree_util.tree_map(
        lambda s: (scale(s) * rng.standard_normal(s.shape)).astype(np.float32), template)


@pytest.mark.parametrize("kind", ["cae", "inr"])
@pytest.mark.parametrize("n", [64, 33])
def test_surrogate_forward_matches_cppre(kind, n):
    """At 33 the CAE's halvings round up and its doublings do not: both
    packages give 40 x 40 (SAME padding of the stride-2 convolutions, and
    flax's ConvTranspose, are what the port reproduces)."""
    jm, params, tm, coords, pf = _surrogate_pair(kind, n)
    want = jax.jit(jm.apply)(params, coords, pf)
    with torch.no_grad():
        got = tm(torch.from_numpy(coords), torch.from_numpy(pf))
    _close(got, want, 1e-5)


def test_one_adam_step_matches_optax():
    """The surrogate training's step from cppre's initial weights and one
    batch (the INR; the optimizer is the CAE's too): the MSE's gradients
    against jax.grad of cppre's loss, then one step of `_train_surrogate`'s
    Adam (lr, eps, bias correction) on those gradients against
    `optax.adam`. (The sign-like first update, g / (|g| + eps), turns a
    1e-11 rounding of a gradient near eps into a 1e-6 move, so the two are
    held apart.)"""
    import optax

    n_px, n = 8, 4
    cfg = {"Learning Rate": 1e-3}
    rng = np.random.default_rng(3)
    coords = rng.random((n, 2, n_px, n_px)).astype(np.float32)
    pf = rng.random((n, 12)).astype(np.float32)
    psi = rng.random((n, 1, n_px, n_px)).astype(np.float32)
    jm = JINR(width=32, depth=2, n_freqs=4)
    p0 = _random_tree(jm, 0, coords[:1], pf[:1])
    loss_of = lambda p: jnp.mean((jm.apply(p, coords, pf) - psi) ** 2)
    loss, grads = jax.device_get(jax.jit(jax.value_and_grad(loss_of))(p0))
    tx = optax.adam(cfg["Learning Rate"])
    p1 = jax.device_get(jax.jit(
        lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p))[0]))(p0, grads))

    make = lambda: INR(width=32, depth=2, n_freqs=4, device="cpu")
    model = inr_from_jax(p0, make())
    ours = gs._mse(model, torch.from_numpy(coords), torch.from_numpy(pf),
                   torch.from_numpy(psi))
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(loss), rtol=1e-5)
    want_grads = inr_from_jax(grads, make()).state_dict()
    opt = gs._adam(model, cfg)
    for name, p in model.named_parameters():
        _close(p.grad, want_grads[name].numpy(), 1e-5)
        p.grad.copy_(want_grads[name])
    opt.step()
    want = inr_from_jax(p1, make()).state_dict()
    for name, value in model.state_dict().items():
        _close(value, want[name].numpy(), 1e-5)


def test_freegsnke_cae_pipeline_coverage():
    """The reduced FreeGSNKE flow of `tests/test_gs.py`: the CAE on
    Solov'ev equilibria, the GS PRE, marginal CP tracks the diagonal."""
    out = gs.run_freegsnke(config={"n_total": 120, "n_train": 60, "Epochs": 120}, seed=0,
                           verbose=False, device="cpu")
    ideal = 1 - out["alphas"]
    assert np.mean(np.abs(out["coverage_marginal"] - ideal)) < 0.15
    assert np.all(np.isfinite(out["coverage_joint"]))
    assert np.isfinite(out["mse"]) and out["train_time"] > 0


def test_freegsnke_inr_pipeline_coverage():
    out = gs.run_freegsnke(config={"n_total": 120, "n_train": 60, "Epochs": 60,
                                   "Model": "INR", "NR": 32, "NZ": 32},
                           seed=0, verbose=False, device="cpu")
    assert isinstance(out["model"], INR)
    ideal = 1 - out["alphas"]
    assert np.mean(np.abs(out["coverage_marginal"] - ideal)) < 0.15
    assert np.all(np.isfinite(out["coverage_joint"]))


def test_efit_pipeline_coverage(tmp_path):
    out = gs.run_efit(seed=0, verbose=False, device="cpu")
    ideal = 1 - out["alphas"]
    assert np.all(out["coverage"] >= ideal - 0.05)
    gs.run_efit(seed=0, verbose=False, device="cpu", plots_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["efit_wall_contour.pdf"]


def test_load_efit_csv_and_run_efit_on_it(tmp_path):
    """A CSV in the reference's layout (index, then six n_grid^2 blocks a
    row) reads as cppre reads it, and `run_efit` on it matches cppre."""
    n_grid, rows = 9, 12
    R, Z, _, psi = solovev.solovev_batch(rows, n_grid, n_grid, seed=4)
    rng = np.random.default_rng(4)
    pred = psi + 1e-3 * rng.standard_normal(psi.shape).astype(np.float32)
    blocks = [psi, pred] + [rng.random(psi.shape).astype(np.float32) for _ in range(4)]
    table = np.concatenate([np.arange(rows, dtype=np.float32)[:, None]]
                           + [b.reshape(rows, -1) for b in blocks], axis=1)
    path = tmp_path / "efit.csv"
    np.savetxt(path, table, delimiter=",")
    got = gs.load_efit_csv(str(path), n_grid=n_grid)
    want = jgs.load_efit_csv(str(path), n_grid=n_grid)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dr, dz = float(R[1] - R[0]), float(Z[1] - Z[0])
    out = gs.run_efit(*got, R=R, dr=dr, dz=dz, verbose=False, device="cpu")
    ref = jgs.run_efit(*want, R=R, dr=dr, dz=dz, verbose=False)
    np.testing.assert_allclose(out["coverage"], np.asarray(ref["coverage"]), atol=1e-3)
    with pytest.raises(ValueError, match="expected >="):
        gs.load_efit_csv(str(path), n_grid=n_grid + 9)
