"""The CUDA kernels of cppre_torch against their plain versions, on the card.

Marked `cuda`: every test skips where `torch.cuda.is_available()` is False
(decided inside the fixture, never at import). The shapes are small and
ragged — widths, grids and batch sizes that are not multiples of the
kernels' tiles — to exercise the edge handling the flagship shapes of
`chip_smoke.py` do not. This file imports neither JAX nor cppre, so it
runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances (float32, another summation order than the plain version):
1e-5 of max|plain| for the stencil kernels, 1e-4 for the FNO kernels'
outputs and for dx/dz of their backward passes; 1e-3 for the backward
weight gradients, which are sums over every pixel of the batch taken in
another order than autograd's. K9's scores agree with the two-pass route's
within 1e-6 relative (the same cell forms each diff; the epilogue's
arithmetic is repeated in the kernel). K3 equals K1, and K11 then K12 equal
K10, bit for bit: each pair calls one cell in one batch order. The JOREK
cell runs in K1, K2 and K3 for affine and non-affine major-radius grids.
"""

import ctypes

import numpy as np
import pytest
import torch

from cppre_torch.models import FNO2d, fno2d_forward_fused, make_fused_train_apply
from cppre_torch.ops import kernels as K
from cppre_torch.ops.kernels import flat_kernels as fk
from cppre_torch.ops.kernels import stencil_kernels as sk
from cppre_torch.train.loops import make_optimizer, make_train_step
from cppre_torch.train.losses import lp_loss

pytestmark = pytest.mark.cuda
ARGS = (0.01, 0.02, 0.03, 1e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, seed, dev):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape).astype(np.float32),
                        device=dev)


def _close(got, ref, rel):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shape", [(3, 4, 5, 13, 37), (2, 3, 3, 3, 200)])
def test_ns_momentum_residual_kernel(dev, shape):
    f = _randn(shape, 0, dev)
    before = K.launch_counts()["K2"]
    _close(K.ns_momentum_residual_fused(f, *ARGS), K.ns_momentum_residual_plain(f, *ARGS), 1e-5)
    assert K.launch_counts()["K2"] == before + 1


@pytest.mark.parametrize("diff_dtype", [None, torch.bfloat16])
def test_ns_joint_cp_diff_stats_kernel(dev, diff_dtype):
    t = _randn((5, 3, 6, 11, 133), 1, dev)
    p = t + 0.1 * _randn(t.shape, 2, dev)
    got = K.ns_joint_cp_diff_stats(t, p, *ARGS, diff_dtype=diff_dtype)
    ref = K.ns_joint_cp_diff_stats_plain(t, p, *ARGS, diff_dtype=diff_dtype)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5 if g.dtype == torch.float32 else 1e-2)
    # bit-stable from run to run: a fixed per-thread order over the batch
    again = K.ns_joint_cp_diff_stats(t, p, *ARGS, diff_dtype=diff_dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(K.ns_joint_cp_scores_fused(t, p, *ARGS, diff_dtype=diff_dtype),
           K.ns_joint_cp_scores_plain(t, p, *ARGS, diff_dtype=diff_dtype), 1e-5)


@pytest.mark.parametrize("width,nx,ny,m1,m2", [(4, 12, 10, 3, 3), (8, 16, 8, 4, 5),
                                               (16, 20, 150, 5, 8), (32, 9, 7, 2, 4)])
def test_fno_block_kernel(dev, width, nx, ny, m1, m2):
    model = FNO2d(1, 1, m1, m2, 2, width, device=dev,
                  generator=torch.Generator().manual_seed(width))
    x = _randn((3, width, 2, nx, ny), 3, dev)
    x3 = _randn((1, width, 2, nx, ny), 4, dev)
    with torch.no_grad():
        _close(K.fno_block2d_fused(x, model.f1, x3, m1, m2),
               K.fno_block2d_plain(x, model.f1, x3, m1, m2), 1e-4)


# Every compiled width at every step class of K5/K7 (1, 2-4, 5-10), with
# the first five cases of each test kept from before; besides z of 378
# pixels (not a multiple of the 32-pixel tile) each case takes npix 15
# (below one tile) and, at batch 7, 22 400 (the 264 blocks of K5's and
# K7's fixed grid walk several tiles each).
_HEAD_CASES = [(4, 1), (16, 3), (32, 8), (16, 10), (32, 10), (4, 3), (4, 10), (8, 1), (8, 3),
               (8, 10), (16, 1), (32, 1), (32, 3)]
_HEAD_SHAPES = [(1, 1, 3, 5), (7, 2, 40, 40)]


@pytest.mark.parametrize("width,step", _HEAD_CASES)
def test_projection_kernel(dev, width, step):
    model = FNO2d(1, step, 2, 2, 2, width, device=dev,
                  generator=torch.Generator().manual_seed(step))
    z = _randn((3, 2, 7, 9, width), 5, dev)
    with torch.no_grad():
        _close(K.projection2d_fused(z, model.fc1_time, model.fc2_time),
               K.projection2d_plain(z, model.fc1_time, model.fc2_time), 1e-4)
        for i, shape in enumerate(_HEAD_SHAPES):
            z = _randn(shape + (width,), 70 + i, dev)
            got = K.projection2d_fused(z, model.fc1_time, model.fc2_time)
            _close(got, K.projection2d_plain(z, model.fc1_time, model.fc2_time), 1e-4)
            # a sample alone gives the bits it has inside the batch
            last = shape[0] - 1
            assert torch.equal(K.projection2d_fused(z[last:].contiguous(), model.fc1_time,
                                                    model.fc2_time), got[last:])


def test_fused_forward_is_batch_invariant_and_matches_the_model(dev):
    model = FNO2d(1, 1, 4, 4, 3, 16, device=dev, generator=torch.Generator().manual_seed(7))
    x = _randn((9, 3, 24, 18, 1), 6, dev)
    K.reset_launch_counts()
    full = fno2d_forward_fused(model, x)
    assert K.launch_counts()["K4"] == 6 and K.launch_counts()["K5"] == 1
    assert torch.equal(fno2d_forward_fused(model, x[:4].contiguous()), full[:4])
    with torch.no_grad():
        _close(full, model(x), 1e-4)


def test_kernels_refuse_what_they_do_not_take(dev):
    model = FNO2d(1, 1, 2, 2, 1, 12, device=dev)          # width 12 is not compiled
    x = _randn((1, 12, 1, 8, 8), 7, dev)
    with pytest.raises(ValueError):
        K.fno_block2d_fused(x, model.f0, x[:1], 2, 2)
    f = _randn((2, 3, 5, 8, 9), 8, dev)
    with pytest.raises(ValueError):
        K.ns_momentum_residual_fused(f.transpose(3, 4), *ARGS)   # not contiguous
    with pytest.raises(TypeError):
        K.ns_momentum_residual_fused(f.double(), *ARGS)


def test_fused_applies_refuse_shapes_the_kernels_do_not_take(dev):
    """On the card there is no plain fallback: the width-12 model raises,
    and so does training where only K6's tile stage is too large."""
    from cppre_torch.models import make_fused_apply

    narrow = FNO2d(1, 1, 2, 2, 1, 12, device=dev)
    with pytest.raises(ValueError, match="width 12"):
        make_fused_apply(narrow)(_randn((1, 1, 8, 8, 1), 16, dev))
    wide = FNO2d(1, 1, 8, 60, 1, 32, device=dev)
    x = _randn((1, 1, 16, 128, 1), 17, dev)
    with pytest.raises(ValueError, match="K6's tile stage"):
        make_fused_train_apply(wide)(x)
    assert make_fused_apply(wide)(x).shape == (1, 1, 16, 128, 1)


def test_fno2d_defaults_to_the_card(dev):
    model = FNO2d(1, 1, 2, 2, 1, 4)
    assert all(p.device.type == "cuda" for p in model.parameters())


def _grads_close(got, ref, what):
    """dx/dz (the first output) at 1e-4 of max|plain|, weight grads at 1e-3."""
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (what, i)
        _close(g, r, 1e-4 if i == 0 else 1e-3)


@pytest.mark.parametrize("width,nx,ny,m1,m2", [(4, 12, 10, 3, 3), (16, 20, 150, 5, 8),
                                               (8, 16, 8, 4, 5), (32, 9, 7, 2, 4)])
def test_fno_block_bwd_kernel(dev, width, nx, ny, m1, m2):
    model = FNO2d(1, 1, m1, m2, 2, width, device=dev,
                  generator=torch.Generator().manual_seed(width + 1))
    x = _randn((3, width, 2, nx, ny), 9, dev)
    g = _randn(x.shape, 10, dev)
    x3 = _randn((1, width, 2, nx, ny), 11, dev)
    before = K.fno_block2d_bwd_fused.launches
    got = K.fno_block2d_bwd_fused(x, g, model.f3, x3, m1, m2)
    assert K.fno_block2d_bwd_fused.launches == before + 1
    _grads_close(got, K.fno_block2d_bwd_plain(x, g, model.f3, x3, m1, m2), "K6")
    # bit-stable: every cross-block sum has one fixed order
    again = K.fno_block2d_bwd_fused(x, g, model.f3, x3, m1, m2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("width", [4, 8, 16, 32])
@pytest.mark.parametrize("ny", [7, 33, 100, 150])
def test_fno_block_kernels_at_ragged_tiles(dev, width, ny):
    """K4 and K6 where the pixel tiles are ragged: several 7-wide rows
    stacked in one tile, 33 (a tile of 3 rows of 36), 100 (one row of a
    128-pixel tile) and 150 (two segments of 76); an odd number of rows,
    six variables. K6 twice gives equal bits."""
    nx, m1, m2 = 9, 3, min(5, ny // 2 + 1)
    model = FNO2d(1, 1, m1, m2, 6, width, device=dev,
                  generator=torch.Generator().manual_seed(ny + width))
    x = _randn((1, width, 6, nx, ny), 60, dev)
    g = _randn(x.shape, 61, dev)
    x3 = _randn((1, width, 6, nx, ny), 62, dev)
    with torch.no_grad():
        _close(K.fno_block2d_fused(x, model.f4, x3, m1, m2),
               K.fno_block2d_plain(x, model.f4, x3, m1, m2), 1e-4)
    got = K.fno_block2d_bwd_fused(x, g, model.f4, x3, m1, m2)
    _grads_close(got, K.fno_block2d_bwd_plain(x, g, model.f4, x3, m1, m2), "K6")
    again = K.fno_block2d_bwd_fused(x, g, model.f4, x3, m1, m2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fno_block_kernel_is_batch_invariant(dev):
    """A sample's K4 output is the same bits alone and inside a batch of 7
    (the CP exchangeability the invariance phase of chip_smoke.py holds)."""
    model = FNO2d(1, 1, 8, 8, 3, 16, device=dev, generator=torch.Generator().manual_seed(63))
    x = _randn((7, 16, 3, 37, 100), 64, dev)
    x3 = _randn((1, 16, 3, 37, 100), 65, dev)
    with torch.no_grad():
        full = K.fno_block2d_fused(x, model.f2, x3, 8, 8)
        for i in (0, 3, 6):
            assert torch.equal(K.fno_block2d_fused(x[i:i + 1].contiguous(), model.f2, x3, 8, 8),
                               full[i:i + 1])


def test_fno_block_bwd_blocks_walk_several_tiles(dev):
    """K6's stage 2 runs a fixed grid: here fewer blocks than tiles, so a
    block adds several tiles into its registers in order; the result holds
    against the plain version and repeats bit for bit."""
    from cppre_torch.ops.kernels import _build

    b, width, v, nx, ny = 3, 16, 2, 65, 128
    lib = _build.library("fno_block_bwd")
    n_blocks = _build.declare(lib, "cppre_fno_block2d_bwd_blocks", [ctypes.c_int] * 5,
                              ctypes.c_longlong)(b, width, v, nx, ny)
    assert n_blocks < b * v * nx                       # one 128-pixel tile per row
    model = FNO2d(1, 1, 6, 8, v, width, device=dev, generator=torch.Generator().manual_seed(66))
    x = _randn((b, width, v, nx, ny), 67, dev)
    g = _randn(x.shape, 68, dev)
    x3 = _randn((1, width, v, nx, ny), 69, dev)
    got = K.fno_block2d_bwd_fused(x, g, model.f1, x3, 6, 8)
    _grads_close(got, K.fno_block2d_bwd_plain(x, g, model.f1, x3, 6, 8), "K6")
    again = K.fno_block2d_bwd_fused(x, g, model.f1, x3, 6, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("width,step", _HEAD_CASES)
def test_projection_bwd_kernel(dev, width, step):
    from cppre_torch.ops.kernels import _build

    blocks = _build.declare(_build.library("fno_block_bwd"), "cppre_projection2d_bwd_blocks",
                            [ctypes.c_longlong], ctypes.c_longlong)
    assert blocks(7 * 2 * 40 * 40) * 32 < 7 * 2 * 40 * 40 / 2   # two tiles a block or more
    model = FNO2d(1, step, 2, 2, 2, width, device=dev,
                  generator=torch.Generator().manual_seed(step + 5))
    for i, shape in enumerate([(3, 2, 7, 9)] + _HEAD_SHAPES):
        z = _randn(shape + (width,), 12 + 10 * i, dev)
        g = _randn(z.shape[:-1] + (step,), 13 + 10 * i, dev)
        got = K.projection2d_bwd_fused(z, g, model.fc1_time, model.fc2_time)
        _grads_close(got, K.projection2d_bwd_plain(z, g, model.fc1_time, model.fc2_time), "K7")
        again = K.projection2d_bwd_fused(z, g, model.fc1_time, model.fc2_time)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_train_step_matches_plain_autograd(dev):
    """One train step through K4-K7 and through model autograd, from the
    same weights and batch: the loss and every gradient agree; the
    counters show K4 twice per block and step (forward and recompute)."""
    a = FNO2d(1, 1, 4, 4, 3, 16, device=dev, generator=torch.Generator().manual_seed(3))
    b = FNO2d(1, 1, 4, 4, 3, 16, device=dev, generator=torch.Generator().manual_seed(3))
    xx = _randn((2, 3, 24, 18, 1), 14, dev)
    yy = _randn((2, 3, 24, 18, 3), 15, dev)
    losses, grads = [], []
    K.reset_launch_counts()
    for model, fn in ((a, make_fused_train_apply(a)), (b, b)):
        opt = make_optimizer(model.parameters(), 5e-3)
        step = make_train_step(fn, opt, 1, 3, lp_loss)
        opt.zero_grad()
        loss, full = step(xx, yy)
        losses.append(float(loss))
        grads.append([p.grad for p in model.parameters()])
    assert K.launch_counts() == dict({k: 0 for k in K.KERNELS},
                                     K4=36, K5=6, K6=18, K7=3)
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for ga, gb in zip(*grads):
        _close(ga, gb, 1e-3)


# ---- the wave and MHD instances, K8 and K9 -----------------------------------

def _mhd(shape, seed, dev):
    f = _randn(shape, seed, dev)
    f[:, 0] = 1.5 + 0.3 * torch.tanh(f[:, 0])   # density away from 0
    return f


def _taps(k, seed):
    kern = np.random.default_rng(seed).standard_normal((k, k, k)).astype(np.float32)
    kern[np.random.default_rng(seed + 1).random(kern.shape) < 0.4] = 0.0
    return kern


@pytest.mark.parametrize("k,take_abs", [(3, False), (3, True), (5, False), (5, True)])
def test_stencil_kernel(dev, k, take_abs):
    f = _randn((3, 9, 13, 70), 20, dev)
    kern = _taps(k, 21)
    before = K.launch_counts()["K8"]
    got = K.fused_stencil_residual(f, kern, take_abs=take_abs)
    assert K.launch_counts()["K8"] == before + 1
    _close(got, K.fused_stencil_residual_plain(f, kern, take_abs=take_abs), 1e-5)
    with pytest.raises(ValueError):
        K.fused_stencil_residual(f, np.ones((2, 2, 2), np.float32))   # even extent


@pytest.mark.parametrize("equation", K.MHD_EQUATIONS)
def test_mhd_residual_kernel(dev, equation):
    f = _mhd((3, 6, 5, 17, 133), 22, dev)
    before = K.launch_counts()["K2"]
    _close(K.mhd_residual_fused(f, equation), K.mhd_residual_plain(f, equation), 1e-5)
    assert K.launch_counts()["K2"] == before + 1


@pytest.mark.parametrize("family", ["wave3", "wave5", "mhd"])
def test_wave_and_mhd_diff_stats_kernel(dev, family):
    if family == "mhd":
        t = _mhd((5, 6, 6, 11, 40), 23, dev)
        run = lambda a, b: K.mhd_joint_cp_diff_stats(a, b)
        plain = lambda a, b: K.mhd_joint_cp_diff_stats_plain(a, b)
    else:
        kern = _taps(3 if family == "wave3" else 5, 24)
        t = _randn((5, 8, 12, 70), 23, dev)
        run = lambda a, b: K.wave_joint_cp_diff_stats(a, b, kern)
        plain = lambda a, b: K.wave_joint_cp_diff_stats_plain(a, b, kern)
    p = t + 0.1 * _randn(t.shape, 25, dev)
    got = run(t, p)
    for g, r in zip(got, plain(t, p)):
        _close(g, r, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, run(t, p)))


@pytest.mark.parametrize("family", ["ns", "mhd"])
def test_single_pass_scores_kernel(dev, family):
    if family == "ns":
        t = _randn((6, 3, 7, 12, 140), 26, dev)
        run = lambda a, b, sp: K.ns_joint_cp_scores_fused(a, b, *ARGS, single_pass=sp)
        plain = lambda a, b: K.ns_joint_cp_scores_plain(a, b, *ARGS)
    else:
        t = _mhd((6, 6, 7, 12, 140), 26, dev)
        run = lambda a, b, sp: K.mhd_induction_joint_cp_scores_fused(a, b, single_pass=sp)
        plain = lambda a, b: K.mhd_induction_joint_cp_scores_plain(a, b)
    p = t + 0.1 * _randn(t.shape, 27, dev)
    before = K.launch_counts()
    one = run(t, p, True)
    assert K.launch_counts()["K9"] == before["K9"] + 1
    assert K.launch_counts()["K1"] == before["K1"]
    two = run(t, p, False)
    _close(one, plain(t, p), 1e-5)
    assert (one - two).abs().max().item() <= 1e-6 * two.abs().max().item()
    assert torch.equal(one, run(t, p, True))


@pytest.mark.parametrize("width,v,nx,ny,m", [(32, 1, 64, 64, 16), (16, 6, 128, 128, 8)])
def test_fno_block_kernels_at_wave_and_mhd_shapes(dev, width, v, nx, ny, m):
    """K4 and K6 at the wave model's (width 32, modes 16, one variable,
    64x64) and the MHD model's (width 16, modes 8, six variables, 128x128)
    shapes."""
    model = FNO2d(1, 1, m, m, v, width, device=dev,
                  generator=torch.Generator().manual_seed(width + v))
    x = _randn((2, width, v, nx, ny), 28, dev)
    x3 = _randn((1, width, v, nx, ny), 29, dev)
    g = _randn(x.shape, 30, dev)
    with torch.no_grad():
        _close(K.fno_block2d_fused(x, model.f2, x3, m, m),
               K.fno_block2d_plain(x, model.f2, x3, m, m), 1e-4)
    _grads_close(K.fno_block2d_bwd_fused(x, g, model.f2, x3, m, m),
                 K.fno_block2d_bwd_plain(x, g, model.f2, x3, m, m), "K6")


def test_made_from_nothing_defaults_to_the_card(dev):
    """The normalizers, solvers and carried normalizers that make tensors of
    their own put them on the card by default."""
    from cppre_torch.solvers import Wave2D, mhd_solve_batch
    from cppre_torch.train.normalizers import Identity, MinMaxNormalizer, _AffineNormalizer
    from cppre_torch.utils import normalizer_from_jax

    class _JaxLike:            # a cppre normalizer's coefficients, as numpy
        a, b = np.float32(2.0), np.float32(-1.0)

    for norm in (Identity(), _AffineNormalizer.from_ab(2.0, -1.0), normalizer_from_jax(_JaxLike)):
        assert norm.a.device.type == "cuda" and norm.b.device.type == "cuda"
    assert Identity(torch.zeros(3)).a.device.type == "cpu"       # follows a given tensor
    assert MinMaxNormalizer(_randn((4, 3), 31, dev)).a.device.type == "cuda"
    assert Wave2D(16, -1.0, 1.0, 1.0, 1.0).solve_batch([[20.0, 0.3, 0.3]]).is_cuda
    assert mhd_solve_batch([[0.7, 0.8, 0.6]], 16, 1.0, 0.002, dt=1e-3, store_every=1)[0].is_cuda


# ---- the JOREK instances of K2, K1 and K3 ----------------------------------------

def _jorek_r(nx, affine=True):
    """A major-radius grid over [2.6, 3.4] (the JOREK experiment's), or a
    non-affine one."""
    r = np.linspace(2.6, 3.4, nx).astype(np.float32)
    return r if affine else r ** 1.5


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("equation", K.JOREK_EQUATIONS)
def test_jorek_kernels(dev, equation, affine):
    """K2 and K1 (with its centred pass) against their plain versions,
    the scores through K1, K1 bit-stable and K3 equal to it bit for bit, for
    an affine and a non-affine R: the kernels read R from a table, so both
    launch."""
    R = _jorek_r(19, affine)
    t = _randn((4, 3, 7, 19, 133), 52, dev)
    p = t + 0.1 * _randn(t.shape, 53, dev)
    cell = sk._jorek_cell(R, 3.4, 2.25e-7, equation)
    before = K.launch_counts()
    _close(K.jorek_residual_fused(t, R, equation=equation),
           K.jorek_residual_plain(t, R, equation=equation), 1e-5)
    k1 = sk._joint_cp_diff_stats(t, p, cell, centred=True)
    _close(K.jorek_joint_cp_scores_fused(t, p, R, equation=equation),
           K.jorek_joint_cp_scores_plain(t, p, R, equation=equation), 1e-5)
    after = K.launch_counts()
    assert (after["K2"] - before["K2"], after["K1"] - before["K1"]) == (1, 2)
    for g, r in zip(k1, sk._diff_stats_plain(t, p, cell, centred=True)):
        _close(g, r, 1e-5)
    assert all(torch.equal(a, b)
               for a, b in zip(k1, sk._joint_cp_diff_stats(t, p, cell, centred=True)))
    assert all(torch.equal(a, b)
               for a, b in zip(k1, sk._joint_cp_diff_stats_chunked(t, p, cell, centred=True)))


def test_jorek_cell_is_refused_where_it_is_not_built(dev):
    """The JOREK cell is compiled into K1, K2 and K3 only; K9 and the flat
    kernels refuse it at launch."""
    cell = sk._jorek_cell(_jorek_r(12), 3.4, 2.25e-7, "continuity")
    t = _randn((2, 3, 5, 12, 16), 54, dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk._joint_cp_scores_single_pass(t, t, cell, 1e-6)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fk._flat_residual_kernel(t.reshape(2, 3, 5, -1), cell, 16, 16)


# ---- K3 (time-chunked diff and moments) and K10-K12 (flat layout) -------------

def _chunked_case(family, dev):
    """Ragged shapes: tiles of 8 x 32 interior cells and chunks of frames
    that do not divide the grid."""
    if family == "ns":
        t = _randn((3, 3, 12, 21, 70), 40, dev)
        return t, lambda a, b, tb: K.ns_joint_cp_diff_stats_chunked(a, b, *ARGS, t_block=tb), \
            lambda a, b: K.ns_joint_cp_diff_stats(a, b, *ARGS), sk._ns_cell(*ARGS)
    if family == "wave":
        kern = _taps(3, 41)
        t = _randn((4, 11, 19, 45), 40, dev)
        return t, lambda a, b, tb: K.wave_joint_cp_diff_stats_chunked(a, b, kern, t_block=tb), \
            lambda a, b: K.wave_joint_cp_diff_stats(a, b, kern), None
    if family.startswith("jorek"):
        eq, R = family.split("-")[1], _jorek_r(21, affine=False)
        cell = sk._jorek_cell(R, 3.4, 2.25e-7, eq)
        t = _randn((3, 3, 10, 21, 45), 40, dev)
        return t, lambda a, b, tb: K.jorek_joint_cp_diff_stats_chunked(a, b, R, equation=eq,
                                                                       t_block=tb), \
            lambda a, b: sk._joint_cp_diff_stats(a, b, cell)[:3], cell
    eq = family.split("-")[1]
    t = _mhd((3, 6, 10, 17, 40), 40, dev)
    return t, lambda a, b, tb: K.mhd_joint_cp_diff_stats_chunked(a, b, eq, t_block=tb), \
        lambda a, b: K.mhd_joint_cp_diff_stats(a, b, eq), sk._mhd_cell(eq)


@pytest.mark.parametrize("family", ["ns", "wave"] + [f"mhd-{e}" for e in K.MHD_EQUATIONS]
                         + [f"jorek-{e}" for e in K.JOREK_EQUATIONS])
def test_chunked_kernel(dev, family):
    """K3 against its plain version (1e-5 of max), against K1 bit for bit,
    the same bits at every t_block, and its centred second pass K1's."""
    t, chunked, paired, cell = _chunked_case(family, dev)
    p = t + 0.1 * _randn(t.shape, 42, dev)
    before = K.launch_counts()
    got = chunked(t, p, 5)
    assert K.launch_counts()["K3"] == before["K3"] + 1
    ref = (K.wave_joint_cp_diff_stats_plain(t, p, _taps(3, 41)) if family == "wave"
           else sk._diff_stats_plain(t, p, cell)[:3])
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)
    k1 = paired(t, p)
    assert all(torch.equal(a, b) for a, b in zip(got, k1))
    for tb in (1, 2, 3, 8):
        assert all(torch.equal(a, b) for a, b in zip(got, chunked(t, p, tb)))
    if cell is not None:
        m2_k3 = sk._joint_cp_diff_stats_chunked(t, p, cell, centred=True)[3]
        m2_k1 = sk._joint_cp_diff_stats(t, p, cell, centred=True)[3]
        assert torch.equal(m2_k3, m2_k1)


def test_routed_entries_launch_k3_where_routing_says_chunked(dev, monkeypatch):
    t = _randn((3, 3, 5, 40, 70), 43, dev)
    p = t + 0.1 * _randn(t.shape, 44, dev)
    K.reset_launch_counts()
    K.ns_joint_cp_scores_fused(t, p, *ARGS)
    assert K.launch_counts()["K1"] == 1 and K.launch_counts()["K3"] == 0
    monkeypatch.setattr(sk, "routing_decision", lambda *a, **k: "chunked")
    K.reset_launch_counts()
    routed = K.ns_joint_cp_scores_fused(t, p, *ARGS)
    bf = K.ns_joint_cp_scores_fused(t, p, *ARGS, diff_dtype=torch.bfloat16)
    assert K.launch_counts()["K3"] == 2 and K.launch_counts()["K1"] == 0
    res = sk._ns_cell(*ARGS)
    for dtype, scores in ((torch.float32, routed), (torch.bfloat16, bf)):
        d, _, _, m2 = sk._joint_cp_diff_stats(t, p, res, diff_dtype=dtype, centred=True)
        assert torch.equal(scores, sk._scores_from_diff_stats(d, m2, 3, 1e-6))


def _flat_case(family, dev):
    if family == "ns":
        t = _randn((5, 3, 7, 13, 37), 45, dev)
        return t, sk._ns_cell(*ARGS), 37
    if family.startswith("wave"):
        kern = _taps(3, 46)
        kern[1, 1, 1] = 1.0
        if family == "wave-corner":
            kern[1, 0, 0] = 0.5
        else:
            kern[:, 0, 0] = kern[:, 0, 2] = kern[:, 2, 0] = kern[:, 2, 2] = 0.0
        t = _randn((5, 1, 7, 13, 37), 45, dev)
        return t, sk._taps_cell(kern), fk._composite_off(kern, 37)
    t = _mhd((5, 6, 7, 13, 37), 45, dev)
    return t, sk._mhd_cell(family.split("-")[1]), 37


@pytest.mark.parametrize("family", ["ns", "wave", "wave-corner"]
                         + [f"mhd-{e}" for e in K.MHD_EQUATIONS])
def test_flat_kernels(dev, family):
    """K10 against its plain version over the whole flat window (y-wrap
    columns included), K11 then K12 against K10 bit for bit."""
    t, res, off = _flat_case(family, dev)
    p = t + 0.1 * _randn(t.shape, 47, dev)
    tf, pf = t.reshape(t.shape[:3] + (-1,)), p.reshape(p.shape[:3] + (-1,))
    ny = t.shape[-1]
    before = K.launch_counts()
    got = fk._flat_paired_absdiff_stats(tf, pf, res, ny, off)
    r = fk._flat_residual_kernel(tf, res, ny, off)
    two = fk._flat_absdiff_stats_from_res(pf, r, res, ny, off)
    after = K.launch_counts()
    assert [after[k] - before[k] for k in ("K10", "K11", "K12")] == [1, 1, 1]
    for g, ref in zip(got, fk._flat_paired_absdiff_stats_plain(tf, pf, res, ny, off)):
        _close(g, ref, 1e-5)
    _close(r, fk._flat_residual_plain(tf, res, ny, off), 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, two))
    assert all(torch.equal(a, b) for a, b in zip(got, fk._flat_paired_absdiff_stats(tf, pf, res,
                                                                                   ny, off)))


def test_flat_scores_kernel(dev):
    t = _mhd((6, 6, 7, 20, 24), 48, dev)
    p = t + 0.1 * _randn(t.shape, 49, dev)
    _close(K.mhd_joint_cp_scores_flat(t, p, "momentum"),
           K.mhd_joint_cp_scores_flat_plain(t, p, "momentum"), 1e-5)
    tn = _randn((6, 3, 7, 20, 24), 50, dev)
    pn = tn + 0.1 * _randn(tn.shape, 51, dev)
    _close(K.ns_joint_cp_scores_flat(tn, pn, *ARGS), K.ns_joint_cp_scores_flat_plain(tn, pn, *ARGS),
           1e-5)


# ---- K1 and K8 with several samples in flight, taps by value ------------------

# the wave experiment's composite kernel (7 taps, by value), and the same with
# a D_xy cross term (9 taps: no by-value instance, the device table)
def _wave_kernel(corner=False):
    from cppre_torch.residuals import PRE_Wave

    kern = np.asarray(PRE_Wave(0.01, 2 / 63, 1.0).D.kernel, np.float32)
    if corner:
        kern = kern.copy()
        kern[1, 0, 0] = kern[1, 2, 2] = 0.125
    return kern


K1_CELLS = (["ns"] + [f"mhd-{e}" for e in K.MHD_EQUATIONS]
            + [f"jorek-{e}" for e in K.JOREK_EQUATIONS] + ["taps7", "taps9"])


def _k1_case(name, bs, dev, ny=41, nt=6):
    """(truth, prediction, cell) for K1 at a small ragged shape."""
    if name == "ns":
        t, cell = _randn((bs, 3, nt, 11, ny), 60, dev), sk._ns_cell(*ARGS)
    elif name.startswith("mhd"):
        t, cell = _mhd((bs, 6, nt, 9, ny), 60, dev), sk._mhd_cell(name[4:])
    elif name.startswith("jorek"):
        t = _randn((bs, 3, nt, 11, ny), 60, dev)
        cell = sk._jorek_cell(_jorek_r(11, affine=False), 3.4, 2.25e-7, name[6:])
    else:
        t, cell = _randn((bs, 1, nt, 10, ny), 60, dev), sk._taps_cell(_wave_kernel(name == "taps9"))
    return t, t + 0.1 * _randn(t.shape, 61, dev), cell


@pytest.mark.parametrize("bs", [1, 3, 5, 7, 9, 15, 16, 17])
@pytest.mark.parametrize("name", K1_CELLS)
def test_k1_walks_the_batch_in_groups(dev, name, bs):
    """K1 for every cell at batch sizes around its groups of samples: U
    samples a thread (1, 2 or 4) times up to 4 threads a cell (these small
    grids take 4), so 1, U - 1, U + 1, group - 1, group + 1 and multiples.
    diff, sum, sumsq and the centred m2 against the plain version (1e-5 of
    max), equal bits on a rerun; the 7-tap table goes by value, the 9-tap
    one does not."""
    t, p, cell = _k1_case(name, bs, dev)
    if cell.kernel is not None:
        assert sk._taps_by_value(int(np.count_nonzero(cell.kernel))) == (name == "taps7")
    before = K.launch_counts()["K1"]
    got = sk._joint_cp_diff_stats(t, p, cell, centred=True)
    assert K.launch_counts()["K1"] == before + 1
    for g, r in zip(got, sk._diff_stats_plain(t, p, cell, centred=True)):
        _close(g, r, 1e-5)
    assert all(torch.equal(a, b)
               for a, b in zip(got, sk._joint_cp_diff_stats(t, p, cell, centred=True)))


@pytest.mark.parametrize("edge", ["odd-oy", "ot-1"])
@pytest.mark.parametrize("name", ["ns", "jorek-temperature", "taps7", "taps9"])
def test_k1_bf16_diff_and_centred_pass(dev, name, edge):
    """K1 with a bfloat16 diff and the centred pass, at an odd output row and
    at one output frame: the diff within bfloat16's rounding of the plain
    one, the moments and m2 (recomputed from the inputs) within 1e-5 of max
    and equal to the float32 run's bits, equal bits on a rerun."""
    t, p, cell = _k1_case(name, 6, dev, ny=37 if edge == "odd-oy" else 40,
                          nt=3 if edge == "ot-1" else 6)
    run = lambda dtype: sk._joint_cp_diff_stats(t, p, cell, diff_dtype=dtype, centred=True)
    got = run(torch.bfloat16)
    ref = sk._diff_stats_plain(t, p, cell, torch.bfloat16, centred=True)
    assert got[0].dtype == torch.bfloat16 and got[0].shape[1:] == got[1].shape
    assert (got[1].shape[0] == 1) == (edge == "ot-1") and got[1].shape[-1] % 2 == (edge == "odd-oy")
    _close(got[0], ref[0], 1e-2)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, 1e-5)
    f32 = run(None)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], f32[1:]))
    assert torch.equal(got[0], f32[0].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(got, run(torch.bfloat16)))


def _seven_taps(k, seed):
    """A k^3 kernel with 7 non-zero taps (the by-value count) at random places."""
    rng = np.random.default_rng(seed)
    kern = np.zeros(k ** 3, np.float32)
    kern[rng.choice(k ** 3, 7, replace=False)] = rng.standard_normal(7)
    return kern.reshape(k, k, k)


# (kernel, field shape): by-value (7 taps) and device tables, k = 3, 5 and
# 7, one sample, Nt = k, rows with and without 16-byte copies (Ny % 4),
# outputs rows that are not a multiple of 4, several tiles, and a batch cut
# into chunks. A kernel is "wave", "corner", ("seven", k, seed) or (k, seed)
# for `_taps`.
K8_CASES = {
    "wave-k3": ("wave", (1, 3, 12, 68)),
    "corner-k3": ("corner", (1, 3, 12, 71)),
    "k5-7-taps": (("seven", 5, 21), (1, 5, 13, 68)),
    "k5-68-taps": ((5, 7), (2, 6, 9, 71)),
    "k7-7-taps": (("seven", 7, 22), (1, 7, 15, 69)),
    "k7-206-taps": ((7, 21), (1, 7, 17, 70)),
    "wave-tiles": ("wave", (3, 9, 21, 150)),
}


def _k8_kernel(which):
    if isinstance(which, str):
        return _wave_kernel(which == "corner")
    return _seven_taps(*which[1:]) if which[0] == "seven" else _taps(*which)


@pytest.mark.parametrize("take_abs", [False, True])
@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_marches_frames_through_its_ring(dev, case, take_abs):
    """K8 against its plain version (1e-5 of max) and bit for bit on a
    rerun. The 7-tap tables (the wave kernel, and 7 taps at k = 5 and 7) go
    by value; 9, 68 and 206 taps have no instance and read the device table
    in the same kernel body."""
    which, shape = K8_CASES[case]
    kern = _k8_kernel(which)
    n = int(np.count_nonzero(kern))
    assert sk._taps_by_value(n) == (n == 7)
    f = _randn(shape, 62, dev)
    before = K.launch_counts()["K8"]
    got = K.fused_stencil_residual(f, kern, take_abs=take_abs)
    assert K.launch_counts()["K8"] == before + 1
    _close(got, K.fused_stencil_residual_plain(f, kern, take_abs=take_abs), 1e-5)
    assert torch.equal(got, K.fused_stencil_residual(f, kern, take_abs=take_abs))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_k8_slot_holds_a_tile_and_its_halo(dev, k):
    """K8's ring slot covers a 16 x 64 output tile and its k - 1 halo, in
    rows a multiple of 4 floats long (16-byte copies)."""
    rows, rw, _ = sk._march_geom((1, 20, 64, 64), k)
    assert rows == 16 + k - 1
    assert 64 + k - 1 <= rw < 64 + k + 3 and rw % 4 == 0


def test_k8_refuses_a_ring_larger_than_shared_memory(dev):
    """A 23-wide stencil's ring of 26 slots of 38 x 88 floats is more than a
    block's 227 KB of shared memory: the launcher refuses it."""
    k = 23
    kern = np.zeros((k, k, k), np.float32)
    kern[k // 2, k // 2, k // 2] = 1.0
    with pytest.raises(RuntimeError, match="invalid argument"):
        K.fused_stencil_residual(_randn((1, k, k, k), 63, dev), kern)


def test_k1_and_k8_grids(dev):
    """K1: 64 cells of one output frame a block, 1 to 4 threads a cell, more
    where the cells are few (JOREK) than where they fill the card (NS); K8:
    tiles of each sample, its frames cut into chunks only where the batch
    gives fewer than 4 blocks an SM."""
    wave, ns = sk._taps_cell(_wave_kernel()), sk._ns_cell(*ARGS)
    jorek = sk._jorek_cell(_jorek_r(32), 3.4, 2.25e-7, "continuity")
    assert sk._k1_grid((1000, 1, 20, 64, 64), wave)[0] == 18 * 61
    blocks, threads = sk._k1_grid((100, 3, 40, 32, 32), jorek)
    assert blocks == 38 * 15 and threads in (128, 192, 256)
    assert sk._k1_grid((100, 3, 21, 100, 100), ns) == (19 * 151, 64)
    rows = 16   # output rows of a K8 tile
    assert sk._march_geom((1000, 20, 64, 64), 3)[2] == 1000 * -(-62 // rows)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one = sk._march_geom((1, 20, 64, 64), 3)[2]
    assert 4 * sms <= one or one == -(-62 // rows) * 18
