"""cppre_torch FNO2d and its fused inference path vs cppre.

Weights are drawn from a seed, carried into flax by cppre's importer and
back into the port by `cppre_torch.utils.fno2d_from_jax`; inputs are made
with numpy. Tiny
shapes: width 4, modes 2-3, 3 variables, a 12x10 grid (not a multiple of 8,
not square). Tolerances:
* the port's forward vs `FNO2d.apply`: 1e-5 of max|y| (float32 matmuls in
  another order);
* the fused path's plain versions vs cppre's Pallas kernels in interpret
  mode: 1e-5 (the Pallas kernels' polynomial erf is 2.9e-6 absolute off
  exact gelu, cppre/ops/pallas/fno_block.py:269-270);
* batch-shape invariance: 1e-6 on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cppre.models import FNO2d as JFNO2d
from cppre.models import fno2d_forward_fused as j_forward_fused
from cppre.models.fno import count_params as j_count_params
import cppre.train.losses as jlosses
from cppre.train import loops as jloops
from cppre.ops.pallas.fno_block import _dft_tables as j_dft_tables
from cppre.ops.pallas.fno_block import fno_block2d_fused as j_block
from cppre.ops.pallas.fno_block import projection2d_fused as j_projection
from cppre.utils import fno_params_from_torch
from cppre_torch.models import (FNO2d, count_params, fno2d_forward_fused, fused_supported,
                                make_fused_train_apply)
from cppre_torch.models.fno import get_grid
from cppre_torch.ops import kernels as K
from cppre_torch.ops.kernels.fno_block import _dft_tables
from cppre_torch.train.loops import make_optimizer, make_train_step, rollout_loss
from cppre_torch.train.losses import lp_loss
from cppre_torch.utils import fno2d_from_jax, load_checkpoint, save_checkpoint

NV, WIDTH = 3, 4


def _pair(modes=(3, 3), nx=12, ny=10, spectral_impl="dft", seed=0, t_in=1, step=1):
    """(flax model, flax params as numpy, the port's model carrying them).

    The weights are drawn by the port from a seed and taken into flax by
    cppre's own importer (`fno_params_from_torch`, onto an abstract
    template: no flax init to compile), then carried back into a fresh
    port model by `fno2d_from_jax`."""
    jm = JFNO2d(T_in=t_in, step=step, modes1=modes[0], modes2=modes[1], num_vars=NV,
                width_time=WIDTH, spectral_impl=spectral_impl)
    make = lambda s: FNO2d(t_in, step, modes[0], modes[1], NV, WIDTH, spectral_impl=spectral_impl,
                           device="cpu", generator=torch.Generator().manual_seed(s))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, NV, nx, ny, t_in), jnp.float32))
    params = jax.device_get(fno_params_from_torch(make(seed).state_dict(), template))
    return jm, params, fno2d_from_jax(params, make(seed + 1))


def _x(seed, b=4, nx=12, ny=10, t_in=1):
    return np.random.default_rng(seed).standard_normal((b, NV, nx, ny, t_in)).astype(np.float32)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("spectral_impl", ["dft", "fft"])
@pytest.mark.parametrize("modes,t_in,step", [((3, 3), 1, 1), ((2, 3), 2, 2), ((7, 3), 1, 1),
                                              ((3, 3), 10, 10)])
def test_forward_matches_flax_apply(spectral_impl, modes, t_in, step):
    """Both spectral paths; modes (7, 3) on 12 rows routes the dft request to
    the FFT path (2*m1 > Nx), as cppre does."""
    jm, params, tm = _pair(modes, spectral_impl=spectral_impl, t_in=t_in, step=step)
    x = _x(1, t_in=t_in)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    _close(got, ref, 1e-5)


def test_weights_round_trip_bit_for_bit():
    """port -> flax (cppre.utils.fno_params_from_torch) -> port (fno2d_from_jax)
    -> flax gives every weight back exactly; the port's names are the
    reference's."""
    jm, params, tm = _pair(seed=3)
    src = FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(3))
    for k, v in src.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k
    back = fno_params_from_torch(tm.state_dict(), params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert count_params(tm) == j_count_params(params)
    assert tm.f0.conv.weights1.dtype == torch.complex64
    assert tm.f0.mlp.mlp1.weight.shape == (WIDTH, WIDTH, 1, 1, 1)


def test_grid_and_dft_tables_equal_cppre():
    jm, _, _ = _pair()
    for nx, ny in ((12, 10), (100, 100), (7, 33)):
        np.testing.assert_array_equal(get_grid((2, NV, nx, ny)).numpy(),
                                      np.asarray(jm.get_grid((2, NV, nx, ny))))
    for nx, ny, m1, m2 in ((12, 10, 3, 3), (16, 8, 4, 5)):      # (16, 8, 4, 5): Nyquist bin
        for ours, ref in zip(_dft_tables(nx, ny, m1, m2), j_dft_tables(nx, ny, m1, m2)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_fused_forward_plain_path_matches_cppre_pallas():
    """The port's fused forward (CPU: the kernels' plain versions) equals
    cppre's fused forward through the Pallas kernels (interpret mode) and
    the model's own forward."""
    jm, params, tm = _pair(seed=4)
    x = _x(5)
    got = fno2d_forward_fused(tm, torch.tensor(x)).numpy()
    _close(got, j_forward_fused(jm, params, jnp.asarray(x), interpret=True), 1e-5)
    with torch.no_grad():
        _close(got, tm(torch.tensor(x)).numpy(), 1e-5)
    assert fused_supported(tm, x.shape)


@torch.no_grad()
def test_block_and_projection_plain_paths_match_pallas():
    """K4 and K5 plain versions against their Pallas counterparts in
    interpret mode (the Pallas block needs 8-aligned rows: 16x10; the
    Pallas head needs 8-aligned Ny and flattens the plane)."""
    jm, params, tm = _pair(seed=6, nx=16, ny=10)
    r = np.random.default_rng(7)
    x = r.standard_normal((2, WIDTH, NV, 16, 10)).astype(np.float32)
    x3 = r.standard_normal((1, WIDTH, NV, 16, 10)).astype(np.float32)
    got = K.fno_block2d_fused(torch.tensor(x), tm.f2, torch.tensor(x3), 3, 3).numpy()
    ref = j_block(jnp.asarray(x), params["params"]["f2"], jnp.asarray(x3), 3, 3,
                  interpret=True)
    _close(got, ref, 1e-5)
    z = r.standard_normal((2, NV, 6, 8, WIDTH)).astype(np.float32)
    got = K.projection2d_fused(torch.tensor(z), tm.fc1_time, tm.fc2_time).numpy()
    p = params["params"]
    ref = j_projection(jnp.asarray(z), p["fc1_time"], p["fc2_time"], interpret=True)
    _close(got, np.asarray(ref).reshape(got.shape), 1e-5)



def test_step_10_forward_and_train_step_match_cppre():
    """JOREK's head (T_in 10, step 10), the weights carried by
    `fno2d_from_jax`: the fused forward (the kernels' plain versions on the
    CPU) equals cppre's `FNO2d.apply` (1e-5 of max), and a rollout of two
    10-frame chunks through the fused training apply gives cppre's
    chunk-summed loss (1e-4 relative), its gradients (5e-4 of the largest,
    as `tests/test_torch_train.py`) and, through one train step, its
    full-trajectory loss."""
    jm, params, tm = _pair(seed=14, t_in=10, step=10)
    x = _x(15, b=3, t_in=10)
    y = np.random.default_rng(16).standard_normal((3, NV, 12, 10, 20)).astype(np.float32)
    got = fno2d_forward_fused(tm, torch.tensor(x)).numpy()
    assert got.shape == (3, NV, 12, 10, 10)
    _close(got, jm.apply(params, jnp.asarray(x)), 1e-5)

    loss_of = lambda v: jloops.rollout_loss(jm.apply, v, jnp.asarray(x), jnp.asarray(y), 10, 20,
                                            jlosses.lp_loss)
    (lj, pred), gj = jax.value_and_grad(loss_of, has_aux=True)(params)
    loss, _ = rollout_loss(make_fused_train_apply(tm), torch.tensor(x), torch.tensor(y), 10, 20,
                           lp_loss)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-4)
    ours = jax.tree_util.tree_leaves(
        fno_params_from_torch({k: p.grad for k, p in tm.named_parameters()}, params))
    ref = jax.tree_util.tree_leaves(jax.device_get(gj))
    scale = max(np.abs(np.asarray(v)).max() for v in ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=5e-4 * scale)
    step = make_train_step(make_fused_train_apply(tm), make_optimizer(tm.parameters(), 5e-3),
                           10, 20, lp_loss)
    loss, full = step(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-4)
    np.testing.assert_allclose(float(full), float(jlosses.lp_loss(pred, jnp.asarray(y))),
                               rtol=1e-4)

def test_batch_shape_invariance():
    """A sample's output does not depend on the batch it is evaluated in
    (calibration/prediction exchangeability needs it)."""
    _, _, tm = _pair(seed=8)
    x = torch.tensor(_x(9, b=7))
    with torch.no_grad():
        for fwd in (tm, lambda v: fno2d_forward_fused(tm, v)):
            full, part = fwd(x), fwd(x[:3].contiguous())
            np.testing.assert_allclose(part.numpy(), full[:3].numpy(), rtol=0, atol=1e-6)


def test_fused_supported_is_a_shape_rule():
    flagship = FNO2d(1, 1, 8, 8, 3, 16, device="cpu")
    assert fused_supported(flagship, (100, 3, 100, 100, 1))
    assert not fused_supported(flagship, (4, 3, 12, 100, 1))     # 2*m1 > Nx
    assert not fused_supported(flagship, (4, 3, 100, 12, 1))     # m2 > Ny//2+1
    width12 = FNO2d(1, 1, 3, 3, 3, 12, device="cpu")
    step11 = FNO2d(1, 11, 3, 3, 3, 4, device="cpu")
    assert not fused_supported(width12, (4, 3, 12, 10, 1))
    assert not fused_supported(step11, (4, 3, 12, 10, 1))
    jorek = FNO2d(10, 10, 8, 8, 3, 16, device="cpu")            # JOREK's head: step 10
    assert fused_supported(jorek, (5, 3, 32, 32, 10), backward=True)
    assert not fused_supported(flagship, (1, 3, 512, 512, 1))    # plane > shared memory


def test_kernel_limits_name_what_they_break():
    assert K.fno_kernel_limits(16, 1, 100, 100, 8, 8, backward=True) == []
    assert K.fno_kernel_limits(16, 10, 32, 32, 8, 8, backward=True) == []
    broken = K.fno_kernel_limits(12, 11, 512, 512, 300, 300)
    assert len(broken) == 6
    for part, words in zip(broken, ("width 12", "step 11", "modes (300, 300)", "512x512 plane",
                                    "inverse-x stage", "K4's tile stage")):
        assert words in part, (words, part)
    # K6's tile stage outgrows shared memory before K4's does: at width 32
    # with 60 y-modes on a 16x128 grid the forward kernels take the model
    # and the backward ones do not
    wide = FNO2d(1, 1, 8, 60, 3, 32, device="cpu")
    assert fused_supported(wide, (2, 3, 16, 128, 1))
    assert not fused_supported(wide, (2, 3, 16, 128, 1), backward=True)
    assert "K6's tile stage" in K.fno_kernel_limits(32, 1, 16, 128, 8, 60, backward=True)[0]
    # the projection head's kernels K5 and K7 are built for 256 hidden units
    assert K.fno_kernel_limits(16, 1, 100, 100, 8, 8, hidden=128) == [
        "hidden width 128 of the projection head is not 256"]


def test_fused_supported_reads_the_projection_hidden_width():
    """A model whose fc1_time projects to another width than 256 is refused
    by `fused_supported`, forward and backward."""
    from cppre_torch.models.fno import _Linear

    model = FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(5))
    assert fused_supported(model, (2, NV, 12, 10, 1), backward=True)
    model.fc1_time = _Linear(WIDTH, 128, torch.Generator().manual_seed(6))
    model.fc2_time = _Linear(128, 1, torch.Generator().manual_seed(7))
    assert not fused_supported(model, (2, NV, 12, 10, 1))
    assert not fused_supported(model, (2, NV, 12, 10, 1), backward=True)


def test_generator_init_and_checkpoint_round_trip(tmp_path):
    a = FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(11))
    b = FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(11))
    c = FNO2d(1, 1, 3, 3, NV, WIDTH, device="cpu", generator=torch.Generator().manual_seed(12))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    path = save_checkpoint(str(tmp_path / "FNO_NS_run1"), a)
    load_checkpoint(path, c)
    assert all(torch.equal(sa[k], v) for k, v in c.state_dict().items())
