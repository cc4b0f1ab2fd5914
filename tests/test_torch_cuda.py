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


# ---- K2 staging its tiles' frames, K9 keeping its diffs in shared memory ------

# (cell, fields shape, what the case exercises): tiles that do not divide
# the output plane, rows without 16-byte copies (Ny % 4 != 0), one sample,
# one output frame, and batches whose frames run in several blocks (the
# last run shorter) or in one.
K2_CASES = {
    "ns-ragged": ("ns", (3, 3, 7, 21, 75)),
    "ns-ny-odd": ("ns", (2, 3, 6, 13, 41)),
    "ns-bs1": ("ns", (1, 3, 9, 18, 70)),
    "ns-nt3": ("ns", (4, 3, 3, 20, 68)),
    "ns-runs": ("ns", (40, 3, 12, 20, 70)),
    "ns-one-run": ("ns", (300, 3, 5, 20, 40)),
    "jorek-continuity": ("jorek-continuity", (5, 3, 12, 32, 32)),
    "jorek-temperature": ("jorek-temperature", (3, 3, 9, 19, 45)),
}
K2_CASES.update({f"mhd-{e}": (f"mhd-{e}", (3, 6, 7, 17, 70)) for e in K.MHD_EQUATIONS})


def _k2_case(name, dev):
    which, shape = K2_CASES[name]
    if which == "ns":
        return _randn(shape, 70, dev), sk._ns_cell(*ARGS)
    if which.startswith("mhd"):
        return _mhd(shape, 70, dev), sk._mhd_cell(which[4:])
    cell = sk._jorek_cell(_jorek_r(shape[3], affine=False), 3.4, 2.25e-7, which[6:])
    return _randn(shape, 70, dev), cell


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_stages_its_tiles_frames(dev, name, aligned):
    """K2 against its plain version (1e-5 of max) and bit for bit on a rerun,
    for every cell (JOREK on a non-affine R) at ragged shapes, from a
    16-byte-aligned field and from one that is not (4-byte copies)."""
    f, cell = _k2_case(name, dev)
    if not aligned:
        buf = torch.empty(f.numel() + 1, device=dev)
        f = buf[1:].view(f.shape).copy_(f)
        assert f.data_ptr() % 16 != 0
    before = K.launch_counts()["K2"]
    got = sk._batched_residual_fused(f, cell)
    assert K.launch_counts()["K2"] == before + 1
    _close(got, cell.math(f), 1e-5)
    assert torch.equal(got, sk._batched_residual_fused(f, cell))


def test_k2_geometry(dev):
    """K2's tiles follow the plane (NS 98 -> 52-wide, MHD 126 -> 64, JOREK 30
    -> 32), its windows fit three blocks an SM where the cell reads at most
    3 variables and two where it reads more, the small cases run their
    frames as the cases above say, and every output frame is in one run."""
    ns = sk._residual_geom((100, 3, 20, 100, 100), sk._ns_cell(*ARGS))
    mhd = sk._residual_geom((100, 6, 20, 128, 128), sk._mhd_cell("induction"))
    jorek = sk._residual_geom((100, 3, 40, 32, 32),
                              sk._jorek_cell(_jorek_r(32), 3.4, 2.25e-7, "continuity"))
    assert (ns["tile"][1], mhd["tile"][1], jorek["tile"][1]) == (52, 64, 32)
    assert (ns["windows"], mhd["windows"], jorek["windows"]) == (3, 5, 2)
    for g, ot, per_sm in ((ns, 18, 3), (mhd, 18, 2), (jorek, 38, 3)):
        assert per_sm * (g["smem"] + 1024) <= 233472 and g["threads"] <= 256
        assert g["frames"] * g["runs"] >= ot > g["frames"] * (g["runs"] - 1)
    runs = {n: sk._residual_geom(K2_CASES[n][1], _k2_case(n, dev)[1])
            for n in ("ns-runs", "ns-one-run", "ns-nt3")}
    assert runs["ns-runs"]["frames"] > 1 and 10 % runs["ns-runs"]["frames"] != 0
    assert runs["ns-runs"]["runs"] > 1
    assert runs["ns-one-run"]["runs"] == 1 and runs["ns-one-run"]["frames"] == 3
    assert runs["ns-nt3"]["frames"] == 1


def _k9_case(kind, bs, dev, shape=(5, 12, 40)):
    if kind == "ns":
        t, cell = _randn((bs, 3) + shape, 71, dev), sk._ns_cell(*ARGS)
    elif kind == "taps":
        t, cell = _randn((bs, 1) + shape, 71, dev), sk._taps_cell(_wave_kernel(corner=True))
    else:
        t, cell = _mhd((bs, 6) + shape, 71, dev), sk._mhd_cell(kind)
    return t, t + 0.1 * _randn(t.shape, 72, dev), cell


def _k9_check(t, p, cell):
    before = K.launch_counts()
    one = sk._joint_cp_scores_single_pass(t, p, cell, 1e-6)
    after = K.launch_counts()
    assert (after["K9"] - before["K9"], after["K1"] - before["K1"]) == (1, 0)
    two = sk._scores(t, p, cell, 1e-6, 1, None, False, "two-pass")
    _close(one, sk._scores_plain(t, p, cell, 1e-6, None, "plain"), 1e-5)
    assert (one - two).abs().max().item() <= 1e-6 * two.abs().max().item()
    assert torch.equal(one, sk._joint_cp_scores_single_pass(t, p, cell, 1e-6))
    return one


@pytest.mark.parametrize("bs", [1, 7, 100, 1000, 1900])
@pytest.mark.parametrize("kind", ["ns", "induction"])
def test_k9_stashes_the_batch(dev, kind, bs):
    """K9 against its plain version (1e-5 of max) and the two-pass route
    (1e-6), bit for bit on a rerun, at batch sizes whose stash holds 64
    cells (1, 7, 100), 32 cells (1000) and none, the recompute body (1900)."""
    t, p, cell = _k9_case(kind, bs, dev, shape=(4, 6, 9) if bs >= 1000 else (5, 12, 40))
    route = sk._k9_grid(tuple(t.shape), cell)
    assert (route["route"], route["cells"]) == (
        ("stash", 64) if bs <= 100 else ("stash", 32) if bs == 1000 else ("recompute", 0))
    _k9_check(t, p, cell)


@pytest.mark.parametrize("kind", list(K.MHD_EQUATIONS) + ["taps"])
def test_k9_takes_every_cell_it_took(dev, kind):
    """K9 for every MHD equation and a device tap table (9 taps), at a
    ragged plane and a batch that is not a multiple of its groups."""
    _k9_check(*_k9_case(kind, 9, dev, shape=(6, 11, 37)))


@pytest.mark.parametrize("route_bs", [9, 1900])
def test_k9_keeps_a_nan(dev, route_bs):
    """A NaN in one sample's fields makes the modulation of the cells it
    touches NaN, so every score is NaN, as the plain version's and the
    two-pass route's are; both K9 bodies, bit for bit on a rerun."""
    t, p, cell = _k9_case("ns", route_bs, dev, shape=(4, 6, 9))
    t[route_bs // 2, 0, 2, 3, 4] = float("nan")
    one = sk._joint_cp_scores_single_pass(t, p, cell, 1e-6)
    assert bool(torch.isnan(one).all())
    assert bool(torch.isnan(sk._scores_plain(t, p, cell, 1e-6, None, "plain")).all())
    assert bool(torch.isnan(sk._scores(t, p, cell, 1e-6, 1, None, False, "two-pass")).all())
    again = sk._joint_cp_scores_single_pass(t, p, cell, 1e-6)
    assert torch.equal(one.view(torch.int32), again.view(torch.int32))


def test_k9_geometry(dev):
    """K9 at the flagship shapes: 64-cell stashes of the 100-sample batch,
    K1's block count, two threads a cell where the blocks do not all fit at
    once; then the stash's cells, and the recompute body, by batch size."""
    ns = sk._k9_grid((100, 3, 21, 100, 100), sk._ns_cell(*ARGS))
    mhd = sk._k9_grid((100, 6, 20, 128, 128), sk._mhd_cell("induction"))
    assert ns == dict(route="stash", cells=64, blocks=19 * 151, threads=128,
                      smem=101 * 64 * 4, lanes=2)
    assert mhd["blocks"] == 18 * -(-126 * 126 // 64) and mhd["smem"] == 101 * 64 * 4
    assert sk._k9_grid((907, 3, 5, 6, 7), sk._ns_cell(*ARGS))["cells"] == 64
    assert sk._k9_grid((908, 3, 5, 6, 7), sk._ns_cell(*ARGS))["cells"] == 32
    assert sk._k9_grid((1815, 3, 5, 6, 7), sk._ns_cell(*ARGS))["cells"] == 32
    assert sk._k9_grid((1816, 3, 5, 6, 7), sk._ns_cell(*ARGS))["route"] == "recompute"


# ---- K10 on K1's walk, K3 streaming frames, the bwd_impl route ----------------

K10_TAIL_CELLS = ["ns", "wave", "wave-corner", "mhd-continuity", "mhd-energy", "mhd-induction"]


def _k10_tail_case(name, bs, dev):
    """(truth, prediction, cell, Ny, off) flat [BS, nvar, nt, L]: the wave
    experiment's 7-tap kernel (by value), with a D_xy cross term (9 taps,
    the device table, off = Ny + 1); MHD cells with 2 samples in flight and
    no centred pass (continuity, energy) and with K1's 4 (induction)."""
    ny = 37
    if name == "ns":
        t, cell, off = _randn((bs, 3, 7, 13, ny), 80, dev), sk._ns_cell(*ARGS), ny
    elif name.startswith("wave"):
        kern = _wave_kernel(corner=name == "wave-corner")
        t, cell = _randn((bs, 1, 7, 13, ny), 80, dev), sk._taps_cell(kern)
        off = fk._composite_off(kern, ny)
    else:
        t, cell, off = _mhd((bs, 6, 7, 13, ny), 80, dev), sk._mhd_cell(name[4:]), ny
    p = t + 0.1 * _randn(t.shape, 81, dev)
    flat = lambda a: a.reshape(a.shape[:3] + (-1,))
    return flat(t), flat(p), cell, ny, off


@pytest.mark.parametrize("bs", [1, 2, 7, 13])
@pytest.mark.parametrize("name", K10_TAIL_CELLS)
def test_k10_batch_tails_equal_the_two_kernel_route(dev, name, bs):
    """K10 and K12 walk the batch in K1's groups (U samples a thread, up to
    4 threads a cell): at batch sizes that end a group early K10's |d|, sum
    and sumsq equal K11 then K12 bit for bit, and each kernel's its plain
    version within 1e-5 of max."""
    tf, pf, cell, ny, off = _k10_tail_case(name, bs, dev)
    got = fk._flat_paired_absdiff_stats(tf, pf, cell, ny, off)
    r = fk._flat_residual_kernel(tf, cell, ny, off)
    two = fk._flat_absdiff_stats_from_res(pf, r, cell, ny, off)
    assert all(torch.equal(a, b) for a, b in zip(got, two))
    for g, ref in zip(got, fk._flat_paired_absdiff_stats_plain(tf, pf, cell, ny, off)):
        _close(g, ref, 1e-5)
    for g, ref in zip(two, fk._flat_absdiff_stats_from_res_plain(pf, r, cell, ny, off)):
        _close(g, ref, 1e-5)


def test_k10_grid_is_k1s_on_the_flat_window(dev):
    """K10 launches K1's 64-cell blocks over each output frame's flat window,
    32 cells of a row and the 32 below them, 1 to 4 threads a cell."""
    wave = sk._taps_cell(_wave_kernel())
    blocks, threads = fk._k10_grid((1000, 1, 20, 64 * 64), wave, 64, 64)
    assert blocks == 18 * -(-(64 * 64 - 128) // 64) and threads in (64, 128, 192, 256)
    ns = sk._ns_cell(*ARGS)
    assert fk._k10_grid((100, 3, 21, 100 * 100), ns, 100, 100) == (19 * -(-9800 // 64), 64)


def test_k12_grid_is_k10s(dev):
    """K12 launches K10's blocks (K1's 64-cell blocks over the flat window,
    two-row bands where Ny % 64 != 0), 1 to 4 threads a cell in groups of at
    most 8 samples."""
    for shape, cell, ny in (((1000, 1, 20, 64 * 64), sk._taps_cell(_wave_kernel()), 64),
                            ((100, 3, 21, 100 * 100), sk._ns_cell(*ARGS), 100),
                            ((100, 6, 20, 128 * 128), sk._mhd_cell("induction"), 128),
                            ((7, 1, 7, 13 * 37), sk._taps_cell(_wave_kernel(corner=True)), 37)):
        off = ny if cell.kernel is None else fk._composite_off(cell.kernel, ny)
        blocks, threads = fk._k12_grid(shape, cell, ny, off)
        assert blocks == fk._k10_grid(shape, cell, ny, off)[0]
        assert threads in (64, 128, 192, 256)


# (name, cell, [BS, nvar, nt, Nx, Ny]): K11's spans at ragged shapes
K11_SPAN_CASES = [
    ("ns-ny37", "ns", (3, 3, 7, 13, 37)),                       # 4-byte copies
    ("ns-ny36", "ns", (2, 3, 9, 12, 36)),                       # 16-byte copies
    ("taps7-bs1-ot1", "taps7", (1, 1, 3, 12, 36)),              # one sample, one frame
    ("taps9-corner", "taps9", (2, 1, 9, 13, 37)),               # off = Ny + 1
    ("mhd-induction-ragged-span", "mhd-induction", (2, 6, 6, 30, 41)),
    ("mhd-induction-span-ends-mid-row", "mhd-induction", (2, 6, 9, 30, 45)),
    ("mhd-gauss", "mhd-gauss", (3, 6, 5, 17, 40)),
    ("mhd-momentum-six-variables", "mhd-momentum", (2, 6, 6, 30, 41)),   # the first design
    ("ns-wide-rows", "ns", (1, 3, 4, 3, 1400)),                          # the first design
]


def _k11_case(cell_name, shape, dev):
    bs, nvar, nt, nx, ny = shape
    if cell_name == "ns":
        t, cell, off = _randn(shape, 86, dev), sk._ns_cell(*ARGS), ny
    elif cell_name.startswith("taps"):
        kern = _wave_kernel(corner=cell_name == "taps9")
        t, cell, off = _randn(shape, 86, dev), sk._taps_cell(kern), fk._composite_off(kern, ny)
    else:
        t, cell, off = _mhd(shape, 86, dev), sk._mhd_cell(cell_name[4:]), ny
    p = t + 0.1 * _randn(shape, 87, dev)
    flat = lambda a: a.reshape(bs, nvar, nt, nx * ny)
    return flat(t), flat(p), cell, ny, off


@pytest.mark.parametrize("name,cell_name,shape", K11_SPAN_CASES, ids=[c[0] for c in K11_SPAN_CASES])
def test_k11_spans_at_ragged_shapes(dev, name, cell_name, shape):
    """K11 against its plain version (1e-5 of max) and K11 then K12 against
    K10 bit for bit, where Ny is not a multiple of 4 (4-byte copies), the
    window has a corner tap (off = Ny + 1), the window is not a whole
    number of spans, a span ends within a row, one sample has one output
    frame; and on the first design, for a six-variable cell and for rows
    too wide for the ring."""
    tf, pf, cell, ny, off = _k11_case(cell_name, shape, dev)
    geom = fk._k11_grid(tuple(tf.shape), cell, ny, off)
    lo = tf.shape[-1] - 2 * off
    first = name.endswith(("wide-rows", "six-variables"))
    assert geom["route"] == ("thread" if first else "span")
    if name.endswith("ragged-span"):
        assert geom["spans"] > 1 and lo % geom["span"] != 0
    if name.endswith("mid-row"):
        assert geom["spans"] > 1 and geom["span"] % ny != 0
    before = K.launch_counts()["K11"]
    r = fk._flat_residual_kernel(tf, cell, ny, off)
    assert K.launch_counts()["K11"] == before + 1
    _close(r, fk._flat_residual_plain(tf, cell, ny, off), 1e-5)
    two = fk._flat_absdiff_stats_from_res(pf, r, cell, ny, off)
    assert all(torch.equal(a, b)
               for a, b in zip(two, fk._flat_paired_absdiff_stats(tf, pf, cell, ny, off)))
    for g, ref in zip(two, fk._flat_absdiff_stats_from_res_plain(pf, r, cell, ny, off)):
        _close(g, ref, 1e-5)


# (name, cell, [BS, nvar, nt, Nx, Ny]): batches with as many spans as two
# blocks an SM of the card, or half as many, so each block marches its
# frames through the ring (the small shapes above take one frame a block)
K11_MARCH_CASES = [
    ("ns-4-byte-copies", "ns", (33, 3, 12, 90, 101)),
    ("ns-16-byte-copies", "ns", (33, 3, 12, 90, 100)),
    ("taps9-corner", "taps9", (264, 1, 12, 40, 41)),
    ("mhd-induction-chunks", "mhd-induction", (66, 6, 9, 30, 45)),
]


@pytest.mark.parametrize("name,cell_name,shape", K11_MARCH_CASES,
                         ids=[c[0] for c in K11_MARCH_CASES])
def test_k11_marches_its_frames_through_the_ring(dev, name, cell_name, shape):
    """K11 where a block marches several output frames, its ring wrapping
    (MHD induction in two chunks of frames, the second shorter): against its
    plain version (1e-5 of max), K11 then K12 against K10 bit for bit; for
    NS also fields that start 4 bytes into their storage (4-byte copies of
    rows that are multiples of 4), which give the aligned fields' bits."""
    tf, pf, cell, ny, off = _k11_case(cell_name, shape, dev)
    geom = fk._k11_grid(tuple(tf.shape), cell, ny, off)
    assert geom["route"] == "span" and geom["frames"] >= 4
    if name.endswith("chunks"):
        assert geom["chunks"] == 2 and (shape[2] - 2) % geom["frames"] != 0
    r = fk._flat_residual_kernel(tf, cell, ny, off)
    _close(r, fk._flat_residual_plain(tf, cell, ny, off), 1e-5)
    two = fk._flat_absdiff_stats_from_res(pf, r, cell, ny, off)
    assert all(torch.equal(a, b)
               for a, b in zip(two, fk._flat_paired_absdiff_stats(tf, pf, cell, ny, off)))
    if cell_name == "ns":
        shifted = torch.empty(tf.numel() + 1, device=dev)[1:].view(tf.shape)
        shifted.copy_(tf)
        assert torch.equal(fk._flat_residual_kernel(shifted, cell, ny, off), r)


def test_k11_grid(dev):
    """K11's spans: the longest whose ring of 7 slots a variable (3 + 2
    frames, and the two frames at the wrap copied again) keeps two blocks on
    an SM, then equal spans over the window; 256 threads a block, one
    sample a block marching every output frame at the flagship shapes. The
    six-variable cells, and rows too wide for the ring, take the first
    design: one thread an output, 128 a block."""
    ns = fk._k11_grid((100, 3, 21, 100 * 100), sk._ns_cell(*ARGS), 100, 100)
    assert ns["route"] == "span" and (ns["slots"], ns["rings"], ns["threads"]) == (7, 3, 256)
    assert ns["spans"] * ns["span"] >= 9800 > (ns["spans"] - 1) * ns["span"]
    assert ns["slot"] >= ns["span"] + 2 * 100 + 2 and ns["slot"] % 4 == 0
    assert ns["smem"] == 4 * 7 * 3 * ns["slot"] and 2 * (ns["smem"] + 1024) <= 228 * 1024
    assert (ns["frames"], ns["chunks"], ns["blocks"]) == (19, 1, 100 * ns["spans"])
    ind = fk._k11_grid((100, 6, 20, 128 * 128), sk._mhd_cell("induction"), 128, 128)
    assert ind["rings"] == 5 and 2 * (ind["smem"] + 1024) <= 228 * 1024
    wave = fk._k11_grid((1000, 1, 20, 64 * 64), sk._taps_cell(_wave_kernel()), 64, 64)
    assert wave["rings"] == 1 and wave["span"] <= 2048
    six = fk._k11_grid((100, 6, 20, 128 * 128), sk._mhd_cell("energy"), 128, 128)
    assert (six["route"], six["rings"]) == ("thread", 6)
    assert six["blocks"] == -(-(100 * 18 * 126 * 128) // 128)
    wide = fk._k11_grid((1, 3, 4, 3 * 1400), sk._ns_cell(*ARGS), 1400, 1400)
    assert (wide["route"], wide["threads"]) == ("thread", 128)
    assert wide["blocks"] == -(-(2 * 1400) // 128)


K3_RAGGED_CELLS = ["ns", "mhd-induction", "taps7", "jorek-continuity"]


@pytest.mark.parametrize("name", K3_RAGGED_CELLS)
def test_k3_few_tiles_and_a_ragged_last_chunk(dev, name):
    """K3 on a plane of 6 tiles (fewer than the card's SMs) and 101 output
    frames, which its geometry cuts into chunks of 2 (the last one
    shorter): diff, sum, sumsq and the centred m2 equal K1's bit for bit."""
    shape = (3, 3, 103, 20, 40)
    if name == "ns":
        t, cell = _randn(shape, 82, dev), sk._ns_cell(*ARGS)
    elif name.startswith("mhd"):
        t, cell = _mhd((3, 6) + shape[2:], 82, dev), sk._mhd_cell(name[4:])
    elif name == "taps7":
        t, cell = _randn((3, 1) + shape[2:], 82, dev), sk._taps_cell(_wave_kernel())
    else:
        t = _randn(shape, 82, dev)
        cell = sk._jorek_cell(_jorek_r(shape[3], affine=False), 3.4, 2.25e-7, "continuity")
    p = t + 0.1 * _randn(t.shape, 83, dev)
    geom = sk._chunk_geom(tuple(t.shape), cell)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert geom["blocks"] // geom["chunks"] < sms and 101 % geom["frames"] != 0
    got = sk._joint_cp_diff_stats_chunked(t, p, cell, centred=True)
    assert all(torch.equal(a, b)
               for a, b in zip(got, sk._joint_cp_diff_stats(t, p, cell, centred=True)))


def test_k3_geometry(dev):
    """K3's tiles are 8 x 32 output cells with a window frame of 10 x 36
    floats a variable, a ring slot of both tensors' frames (NS: 60 rows of
    36); a block takes at most t_block frames, and fewer where that fills
    the card's SMs in fewer frame steps: the grid-scaling NS shape takes 5
    (4 096 blocks, three an SM, a ring of 7 slots), JOREK's 32 x 32 plane 1
    (38 chunks of its 4 tiles, two windows of 3 slots), MHD induction's 5
    windows (two blocks an SM) 5 of the 8 t_block allows. The slot's
    strides the wrapper builds a tap table for (`_chunk_window`) are the
    library's, for every cell kind."""
    ns, jorek = sk._ns_cell(*ARGS), sk._jorek_cell(_jorek_r(32), 3.4, 2.25e-7, "continuity")
    cells = [ns, jorek, sk._jorek_cell(_jorek_r(32), 3.4, 2.25e-7, "temperature")]
    cells += [sk._mhd_cell(eq) for eq in ("continuity", "momentum", "energy", "induction",
                                          "gauss")]
    for cell in cells + [sk._taps_cell(_wave_kernel())]:
        shape = (2, 1 if cell.kernel is not None else 6, 5, 32, 32)
        assert sk._chunk_geom(shape, cell)["window"] == sk._chunk_window(cell), cell.kind
    g = sk._chunk_geom((12, 3, 21, 512, 512), ns)
    assert (g["tile"], g["window"], g["frames"], g["blocks"]) == ((8, 32), (60, 36), 5, 4096)
    assert (g["smem"], g["threads"], g["ring"], g["per_sm"]) == (60480, 256, 7, 3)
    assert sk._chunk_geom((12, 3, 21, 512, 512), ns, t_block=2)["frames"] <= 2
    g = sk._chunk_geom((100, 3, 40, 32, 32), jorek)
    assert (g["frames"], g["chunks"], g["blocks"], g["ring"]) == (1, 38, 152, 6)
    g = sk._chunk_geom((25, 6, 21, 256, 256), sk._mhd_cell("induction"), t_block=8)
    assert (g["windows"], g["frames"], g["per_sm"]) == (5, 5, 2)


def test_bwd_impl_xla_differentiates_the_plain_math(dev):
    """make_fused_train_apply(model, bwd_impl='xla'): the forward still runs
    K4 and K5, the backward autograd of the plain block and head math (no
    K6 or K7 launch); its gradients agree with the kernels' within 1e-3 of
    each gradient's max (sums over pixels in another order)."""
    model = FNO2d(1, 1, 3, 3, 2, 16, device=dev, generator=torch.Generator().manual_seed(84))
    x = _randn((2, 2, 12, 10, 1), 85, dev)

    def grads(bwd_impl):
        model.zero_grad(set_to_none=True)
        (make_fused_train_apply(model, bwd_impl=bwd_impl)(x) ** 2).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    before = K.launch_counts()
    got = grads("xla")
    after = K.launch_counts()
    assert after["K6"] == before["K6"] and after["K7"] == before["K7"]
    assert after["K4"] > before["K4"] and after["K5"] > before["K5"]
    want = grads("pallas")
    for k, g in want.items():
        g, h = (torch.view_as_real(a) if a.is_complex() else a for a in (g, got[k]))
        assert float((h - g).abs().max()) <= 1e-3 * float(g.abs().max()), k
    with pytest.raises(ValueError, match="bwd_impl"):
        make_fused_train_apply(model, bwd_impl="cuda")


# ---- the UQ harness's shapes and the Bayesian head ---------------------------

@pytest.mark.parametrize("case", ["wave", "ns", "mhd"])
def test_uq_pres_launch_their_kernels(dev, case):
    """The UQ loaders' PREs (`uq.data_loaders.KernelPRE`) at the harness's
    shapes: on the card K8 (wave) and K2 (NS momentum, MHD energy) against
    the plain PRE class on the same fields, 1e-5 of max, one launch each;
    `boundary=True` takes the plain class."""
    from cppre_torch.residuals import PRE_MHD, PRE_NS, PRE_Wave
    from cppre_torch.uq.data_loaders import KernelPRE, _wave_pre

    nvar, make = {"wave": (1, lambda: _wave_pre(0.05, 2 / 63, 1.0)),
                  "ns": (3, lambda: KernelPRE(PRE_NS(0.01, 1 / 64, 1 / 64), lambda f:
                                              K.ns_momentum_residual_fused(f, 0.01, 1 / 64,
                                                                           1 / 64, 1e-3))),
                  "mhd": (6, lambda: KernelPRE(PRE_MHD(0.0025, 1 / 64, 1 / 64),
                                               lambda f: K.mhd_residual_fused(f, "energy")))}[case]
    pre = make()
    fields = _randn((30, nvar, 20, 64, 64), 90, dev)
    if case == "mhd":
        fields[:, 0] = fields[:, 0].abs() + 0.5
    kid = "K8" if case == "wave" else "K2"
    before = K.launch_counts()[kid]
    wide = torch.zeros(fields.shape[:-1] + (65,), device=dev)
    wide[..., :64] = fields
    got = pre.residual(wide[..., :64])                     # a strided view of the fields
    assert K.launch_counts()[kid] == before + 1
    _close(got, pre.pre.residual(fields), 1e-5)
    assert isinstance(pre.pre, (PRE_Wave, PRE_NS, PRE_MHD))
    _close(pre.residual(fields, boundary=True), pre.pre.residual(fields, boundary=True), 0)


def test_uq_wave_model_through_k4_k5(dev):
    """The wave UQ model (width 16, modes 8, one variable) at [30, 1, 64, 64]:
    the fused forward against the module's, 1e-4 of max; the MLE model's
    step-2 head too; a dropout model is refused by both fused applies."""
    from cppre_torch.models import make_fused_apply
    from cppre_torch.models.variants import make_dropout_fno, make_mle_fno

    x = _randn((30, 1, 64, 64, 1), 91, dev)
    for model in (FNO2d(1, 1, 8, 8, 1, 16, device=dev,
                        generator=torch.Generator().manual_seed(92)),
                  make_mle_fno(1, 1, 8, 8, 1, 16, device=dev,
                               generator=torch.Generator().manual_seed(93))):
        with torch.no_grad():
            _close(make_fused_apply(model)(x), model(x), 1e-4)
    drop = make_dropout_fno(1, 1, 8, 8, 1, 16, device=dev)
    for refuse in (make_fused_apply, make_fused_train_apply):
        with pytest.raises(ValueError, match="dropout"):
            refuse(drop)


def test_bayesian_head_through_k5_and_k7(dev):
    """A Bayesian head draw in K5 forward and K7 backward against the
    module's autograd with the same draw: the output 1e-4 of max, the
    gradients of every parameter (weight_mu and weight_log_sigma through
    the reparameterisation) 1e-3 of each gradient's max; K7 launches."""
    from cppre_torch.models import make_fused_apply
    from cppre_torch.models.variants import FNO2dBayesian
    from cppre_torch.uq.train import _draw_eps

    a = FNO2dBayesian(1, 1, 4, 4, 2, 16, device=dev, generator=torch.Generator().manual_seed(94))
    b = FNO2dBayesian(1, 1, 4, 4, 2, 16, device=dev, generator=torch.Generator().manual_seed(94))
    x = _randn((3, 2, 20, 18, 1), 95, dev)
    y = _randn((3, 2, 20, 18, 1), 96, dev)
    eps = _draw_eps(a, torch.Generator(device=dev).manual_seed(97))
    with torch.no_grad():
        _close(make_fused_apply(a, head=a.sample_head(eps=eps))(x),
               b(x, head=b.sample_head(eps=eps)), 1e-4)
    before = K.launch_counts()["K7"]
    outs = []
    for model, fn in ((a, make_fused_train_apply(a)), (b, b)):
        model.zero_grad(set_to_none=True)
        out = fn(x, head=model.sample_head(eps=eps))
        ((out - y) ** 2).sum().backward()
        outs.append(out.detach())
    assert K.launch_counts()["K7"] == before + 1
    _close(outs[0], outs[1], 1e-4)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.grad is not None, name
        _close(p.grad, q.grad, 1e-3)


# ---- the Grad-Shafranov surrogates' CUDA-graph train step ---------------------

@pytest.mark.parametrize("kind", ["cae", "inr"])
def test_gs_graph_step_matches_eager_adam(dev, kind):
    """`experiments.gs._surrogate_step` on the card (an eager first step,
    then one CUDA graph replayed) against eager Adam steps of a twin model
    on the same minibatches: each step's loss 1e-5 relative, every
    parameter after five steps 1e-5 of its max."""
    from cppre_torch.experiments import gs
    from cppre_torch.models import INR, ConvAutoencoder

    make = {"cae": lambda: ConvAutoencoder(grid=(16, 16), device=dev,
                                           generator=torch.Generator().manual_seed(98)),
            "inr": lambda: INR(width=32, depth=2, n_freqs=4, device=dev,
                               generator=torch.Generator().manual_seed(98))}[kind]
    cfg = {"Batch Size": 4, "Learning Rate": 1e-3}
    coords, pf = _randn((10, 2, 16, 16), 99, dev), _randn((10, 12), 100, dev)
    psi = _randn((10, 1, 16, 16), 101, dev)
    graphed, eager = make(), make()
    idx, step = gs._surrogate_step(graphed, coords, pf, psi, cfg)
    opt = gs._adam(eager, cfg)
    for s in range(5):
        rows = torch.tensor([(3 * s + k) % 10 for k in range(4)], device=dev)
        idx.copy_(rows)
        got = float(step())
        opt.zero_grad(set_to_none=True)
        want = gs._mse(eager, coords[rows], pf[rows], psi[rows])
        want.backward()
        opt.step()
        assert abs(got - float(want)) <= 1e-5 * abs(float(want)), s
    for (name, p), q in zip(graphed.named_parameters(), eager.parameters()):
        _close(p.detach(), q.detach(), 1e-5)


def test_mc_dropout_graph_matches_eager(dev):
    """MC dropout on the card (`uq.validation._DropoutForward`: an eager
    first forward, then a CUDA graph with the generator registered) against
    the module's eager forward with the generator rewound to each sample's
    state: the same masks, so the rollouts' mean and std equal bit for bit,
    and the generator ends in the same state."""
    from cppre_torch.models.variants import make_dropout_fno
    from cppre_torch.train.rollout import autoregressive_rollout
    from cppre_torch.uq import validation as V

    model = make_dropout_fno(1, 1, 8, 8, 1, 16, dropout_rate=0.2, device=dev,
                             generator=torch.Generator().manual_seed(102))
    a, u = _randn((6, 1, 32, 32, 1), 103, dev), _randn((6, 1, 32, 32, 5), 104, dev)
    g_graph = torch.Generator(device=dev).manual_seed(105)
    mean, std, mse, _ = V.validation_dropout(model, a, u, 1, 5, 3, g_graph)
    g_eager, rollouts = torch.Generator(device=dev).manual_seed(105), []
    with torch.no_grad():
        for _ in range(3):
            state = g_eager.get_state()

            def eager(x, state=state):
                g_eager.set_state(state)
                return model(x, deterministic=False, generator=g_eager)

            rollouts.append(autoregressive_rollout(eager, a, 1, 5))
    preds = torch.stack(rollouts)
    assert torch.equal(mean, preds.mean(dim=0))
    assert torch.equal(std, preds.std(dim=0, correction=0))
    assert float(std.mean()) > 0
    assert torch.equal(g_graph.get_state(), g_eager.get_state())
    fwd = V._DropoutForward(model, g_graph)
    state = g_graph.get_state()
    with torch.no_grad():
        outs = [fwd(a, state) for _ in range(3)]
    assert len(fwd.graphs) == 1 and torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])


def test_mhd_solver_graph_matches_eager(dev):
    """The MHD solver on the card with its step blocks replayed as a CUDA
    graph against the eager loop: the same kernels in the same order, so
    the frames and the div B error equal bit for bit."""
    from cppre_torch.solvers.mhd2d_constrained import _mhd_run

    params = torch.tensor([[0.7, 0.8, 0.6], [0.9, 0.55, 0.75]], device=dev)
    got = _mhd_run(params, 24, 12, 3, 1 / 24, 1e-3)
    want = _mhd_run(params, 24, 12, 3, 1 / 24, 1e-3, graphs=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(torch.isfinite(got[0]).all())


# ---- K8's backward and the AL / PI paths -------------------------------------

def _plain_vjp(f, kern, g, pad):
    """Autograd of K8's plain twin over the field zero-padded by `pad`."""
    x = f.detach().clone().requires_grad_(True)
    out = K.fused_stencil_residual_plain(sk._pad3(x, pad), kern)
    return torch.autograd.grad(out, x, g)[0]


@pytest.mark.parametrize("pad", [0, "same"])
@pytest.mark.parametrize("which", ["wave", (3, 94), (5, 95)])
def test_k8_backward_is_k8_on_the_flipped_stencil(dev, which, pad):
    """K8's backward against autograd of its plain twin (1e-5 of max) on
    the wave stencil and on asymmetric 3- and 5-wide stencils (a backward
    that forgot the flip passes on the wave stencil alone): one K8 launch
    forward, one K8-bwd launch backward, for the valid interior and for
    the same-size route of the physics-informed loss."""
    kern = _k8_kernel(which)
    k = kern.shape[0]
    p = k // 2 if pad == "same" else 0
    f = _randn((3, 11, 21, 70), 96, dev).requires_grad_(True)
    before = K.launch_counts()
    out = K.fused_stencil_same(f, kern) if p else K.fused_stencil_residual(f, kern)
    g = _randn(tuple(out.shape), 97, dev)
    (got,) = torch.autograd.grad(out, f, g)
    after = K.launch_counts()
    assert (after["K8"] - before["K8"], after["K8-bwd"] - before["K8-bwd"]) == (1, 1)
    _close(out, K.fused_stencil_residual_plain(sk._pad3(f.detach(), p), kern), 1e-5)
    want = _plain_vjp(f, kern, g, p)
    _close(got, want, 1e-5)
    _close(K.fused_stencil_residual_bwd(g, kern, p), want, 1e-5)
    _close(K.fused_stencil_residual_bwd_plain(g, kern, p), want, 1e-6)


def test_k8_backward_takes_a_non_contiguous_cotangent(dev):
    """The PI loss permutes the rollout ([BS, Nx, Ny, T] -> [BS, T, Nx, Ny])
    before K8, so its cotangent can arrive strided: the backward makes it
    contiguous and launches, never falls back."""
    kern = _k8_kernel((3, 98))
    g = _randn((2, 40, 30, 9), 99, dev).permute(0, 3, 1, 2)          # [2, 9, 40, 30]
    assert not g.is_contiguous()
    before = K.launch_counts()["K8-bwd"]
    got = K.fused_stencil_residual_bwd(g, kern, 1)
    assert K.launch_counts()["K8-bwd"] == before + 1
    _close(got, K.fused_stencil_residual_bwd_plain(g.contiguous(), kern, 1), 1e-5)
    field = _randn((2, 40, 30, 9), 100, dev).requires_grad_(True)
    loss = (K.fused_stencil_same(field.permute(0, 3, 1, 2), kern) ** 2).mean()
    loss.backward()
    x = field.detach().clone().requires_grad_(True)
    (K.fused_stencil_same_plain(x.permute(0, 3, 1, 2), kern) ** 2).mean().backward()
    _close(field.grad, x.grad, 1e-5)


def test_k8_take_abs_under_grad_raises(dev):
    f = _randn((2, 6, 20, 20), 101, dev).requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        K.fused_stencil_residual(f, _wave_kernel(), take_abs=True)


def test_pi_wave_and_al_wave_launch_their_kernels(dev):
    """`pi_wave.run` trains through K4-K7 with the PI loss through K8 and
    its backward; `al_more.run("wave")` rolls out through K4/K5, scores
    with K8 and fine-tunes through K6/K7."""
    from cppre_torch.experiments import al_more, pi_wave

    tiny = {"Nx": 32, "n_train": 4, "n_test": 4, "T_out": 4, "Width_time": 8, "Modes": 4,
            "Epochs": 1}
    K.reset_launch_counts()
    out = pi_wave.run("pi", "finetune", config={**tiny, "PI_Epochs": 2}, verbose=False,
                      device=dev)
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("K4", "K5", "K6", "K7", "K8", "K8-bwd")), counts
    assert all(np.isfinite(out[k]) for k in ("mse_before", "mse_after", "pre_before",
                                             "pre_after"))
    K.reset_launch_counts()
    out = al_more.run("wave", "PRE", config={**tiny, "n_cal": 6, "n_pred": 6,
                                             "n_iterations": 1}, verbose=False, device=dev)
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("K4", "K5", "K6", "K7", "K8")), counts
    assert counts["K8-bwd"] == 0 and out["sims_sampled"] == [3]


# ---- sets, neural ODEs and the training options ---------------------------------------

def test_set_pre_batched_on_the_card_matches_the_cpu(dev):
    from cppre_torch.sets import set_PRE, set_pre_batched

    r = np.random.default_rng(110)
    t = np.arange(198) * 0.1010101
    x = (np.cos(t * r.uniform(0.8, 1.2, (37, 1))) * r.uniform(0.5, 1.5, (37, 1))
         + 0.01 * r.standard_normal((37, 198))).astype(np.float32)
    lo, up = set_pre_batched(x, device=dev)
    clo, cup = set_pre_batched(x, device="cpu")
    assert lo.is_cuda
    # 2e-5: each float32 result lies up to ~9e-6 of max|bound| from the
    # float64 bounds (two FFT libraries' rounding of the padded trajectory
    # reach the radii through |residual|)
    _close(lo.cpu(), clo, 2e-5)
    _close(up.cpu(), cup, 2e-5)
    padded = torch.nn.functional.pad(torch.tensor(x, device=dev), (1, 1))
    assert bool((lo <= padded).all()) and bool((up >= padded).all())
    one = np.array(set_PRE(x[0], device=dev))
    scale = float(cup.abs().max())
    assert np.abs(one[:, 0] - clo[0].numpy()).max() <= 2e-4 * scale


def test_node_family_on_the_card(dev):
    """A batched family equals the per-sample loop on the card (1e-6 of
    max|y|, each sample with its own steps), and the CPU's within 1e-4: the
    random field's flow grows the two devices' float32 rounding (1.2e-5
    measured at this seed)."""
    from cppre_torch.node import ODEFunc, neural_odeint

    for time_dependent in (False, True):
        model = ODEFunc(50, 2, time_dependent, device=dev,
                        generator=torch.Generator().manual_seed(111))
        t = np.linspace(1.0, 8.0, 30).astype(np.float32)
        y0 = np.random.default_rng(112).uniform(-1.5, 1.5, (16, 2)).astype(np.float32)
        with torch.no_grad():
            fam, stats = neural_odeint(model, y0, t, return_stats=True)
            loop = torch.stack([neural_odeint(model, y, t) for y in y0])
            cpu = neural_odeint(model.to("cpu"), y0, t)
        _close(fam, loop, 1e-6)
        _close(fam.cpu(), cpu, 1e-4)
        assert stats["accepted"].is_cuda and int(stats["accepted"].min()) > 0


def test_graphed_fit_matches_the_cpu(dev):
    """`fit_node` on the card replays a CUDA graph of each epoch's loss and
    gradient (captured after an eager first epoch, again as the step count
    moves): its losses and weights after 8 epochs against the eager fit on
    the CPU from the same seed (1e-4 relative, 1e-4 of each tensor's max),
    and the gradients it leaves are the graph's own."""
    from cppre_torch.node import ODEFunc, fit_node
    from cppre_torch.node.experiments import _domain, _trajectories

    t = _domain("sho", 60, None)
    target = _trajectories("sho", 1, t, 119)[0]
    state_cpu, losses_cpu = fit_node(ODEFunc(50, 2, device="cpu"), target[0], t, target,
                                     epochs=8, seed=120)
    card = ODEFunc(50, 2, device=dev)
    state, losses = fit_node(card, target[0], t, target, epochs=8, seed=120)
    np.testing.assert_allclose(losses, losses_cpu, rtol=1e-4)
    for k, v in state.items():
        _close(v.cpu(), state_cpu[k], 1e-4)
    assert card.dense0.weight.grad is not None and card.batch_invariant


def test_node_run_and_fit_on_the_card(dev):
    from cppre_torch.node.experiments import run

    out = run("dho", n_cal=8, n_pred=4, Nt=30, epochs=2, verbose=False, device=dev)
    assert np.isfinite(out["mse"]) and 0 <= out["coverage"] <= 1
    assert len(out["fit_losses"]) == 2 and np.isfinite(out["fit_losses"]).all()
    assert next(out["model"].parameters()).is_cuda


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_train_step_at_a_precision_launches_and_restores(dev, precision):
    """"high" and "default" keep the fused route (K4 12, K5 2, K6 6, K7 1 a
    rollout step, recompute included); "bf16" autocasts the plain module and
    launches none. The flags are back at "highest" / False after the step."""
    from cppre_torch.models import with_train_precision

    model = FNO2d(1, 1, 4, 4, 2, 8, device=dev, generator=torch.Generator().manual_seed(113))
    apply = model if precision == "bf16" else make_fused_train_apply(model)
    step = make_train_step(with_train_precision(apply, precision),
                           make_optimizer(model.parameters(), 1e-3), 1, 3, lp_loss)
    xx, yy = _randn((2, 2, 20, 18, 1), 114, dev), _randn((2, 2, 20, 18, 3), 115, dev)
    K.reset_launch_counts()
    loss, _ = step(xx, yy)
    counts = K.launch_counts()
    assert np.isfinite(float(loss))
    want = ({"K4": 0, "K5": 0, "K6": 0, "K7": 0} if precision == "bf16"
            else {"K4": 36, "K5": 6, "K6": 18, "K7": 3})
    assert {k: counts[k] for k in want} == want
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("fused", [False, True])
def test_remat_policies_on_the_card(dev, fused):
    from cppre_torch.train.loops import rollout_loss

    def loss_and_grads(policy):
        model = FNO2d(1, 1, 4, 4, 2, 8, device=dev,
                      generator=torch.Generator().manual_seed(116))
        apply = make_fused_train_apply(model) if fused else model
        xx, yy = _randn((2, 2, 20, 18, 1), 117, dev), _randn((2, 2, 20, 18, 3), 118, dev)
        loss, _ = rollout_loss(apply, xx, yy, 1, 3, lp_loss, remat_policy=policy)
        loss.backward()
        return loss.detach(), [p.grad for p in model.parameters()]

    ref_loss, ref = loss_and_grads(None)
    for policy in ("dots", "dots_no_batch", "everything_saveable"):
        loss, grads = loss_and_grads(policy)
        _close(loss, ref_loss, 1e-6)
        for g, r in zip(grads, ref):
            _close(g, r, 1e-6)
