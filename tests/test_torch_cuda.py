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
