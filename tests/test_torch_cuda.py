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
another order than autograd's.
"""

import numpy as np
import pytest
import torch

from cppre_torch.models import FNO2d, fno2d_forward_fused, make_fused_train_apply
from cppre_torch.ops import kernels as K
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
    before = K.ns_momentum_residual_fused.launches
    _close(K.ns_momentum_residual_fused(f, *ARGS), K.ns_momentum_residual_plain(f, *ARGS), 1e-5)
    assert K.ns_momentum_residual_fused.launches == before + 1


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


@pytest.mark.parametrize("width,step", [(4, 1), (16, 3), (32, 8)])
def test_projection_kernel(dev, width, step):
    model = FNO2d(1, step, 2, 2, 2, width, device=dev,
                  generator=torch.Generator().manual_seed(step))
    z = _randn((3, 2, 7, 9, width), 5, dev)
    with torch.no_grad():
        _close(K.projection2d_fused(z, model.fc1_time, model.fc2_time),
               K.projection2d_plain(z, model.fc1_time, model.fc2_time), 1e-4)


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
    and so does training where only K6's row stage is too large."""
    from cppre_torch.models import make_fused_apply

    narrow = FNO2d(1, 1, 2, 2, 1, 12, device=dev)
    with pytest.raises(ValueError, match="width 12"):
        make_fused_apply(narrow)(_randn((1, 1, 8, 8, 1), 16, dev))
    wide = FNO2d(1, 1, 8, 8, 1, 32, device=dev)
    x = _randn((1, 1, 16, 2000, 1), 17, dev)
    with pytest.raises(ValueError, match="K6's row stage"):
        make_fused_train_apply(wide)(x)
    assert make_fused_apply(wide)(x).shape == (1, 1, 16, 2000, 1)


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


@pytest.mark.parametrize("width,step", [(4, 1), (16, 3), (32, 8)])
def test_projection_bwd_kernel(dev, width, step):
    model = FNO2d(1, step, 2, 2, 2, width, device=dev,
                  generator=torch.Generator().manual_seed(step + 5))
    z = _randn((3, 2, 7, 9, width), 12, dev)
    g = _randn(z.shape[:-1] + (step,), 13, dev)
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
    assert K.launch_counts() == {"K1": 0, "K2": 0, "K4": 36, "K5": 6, "K6": 18, "K7": 3}
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for ga, gb in zip(*grads):
        _close(ga, gb, 1e-3)
