"""FNO2d through the hand-written kernels: inference and training.

Port of `cppre.models.fused`.

* `fno2d_forward_fused(model, x)` computes `model(x)` with each of the six
  Fourier blocks evaluated by kernel K4 (`ops.kernels.fno_block2d_fused`)
  and the projection head by kernel K5 (`projection2d_fused`). The lift,
  the skip adds, the transposes and the bias branch b(grid) stay plain
  torch, as they stay XLA in JAX. Inference only (no autograd).
* `make_fused_train_apply(model, bwd_impl="pallas")` returns a
  differentiable `apply_fn(x)`: the same chain, each block a
  `torch.autograd.Function` with K4 forward and K6 backward, the head one
  with K5 forward and K7 backward (`bwd_impl="xla"`: autograd of the plain
  block and head math in place of K6 and K7, as in cppre). The bias branch
  runs differentiably outside the Function and receives dx3.

The output of a sample does not depend on the batch it is evaluated in:
K4 and K5 work per sample in a fixed order, the skip adds are elementwise,
the bias branch always runs at batch 1, and the lift is written as a sum of
T_in+2 broadcast products, so no library picks a batch-dependent algorithm
for it. Conformal calibration relies on this: calibration and prediction
samples rolled out at different batch sizes stay exchangeable. K6 and K7
sum weight gradients across samples and have no such property (training
needs none).

Both applies refuse a model with dropout (`FNO2d(dropout_rate > 0)`): K4
computes the dropout-free block, as cppre's Pallas block does, so MC-dropout
rolls out through the module's own forward. Both take a `head`, two layers
with .weight and .bias in place of the model's projection, which is how a
Bayesian head's drawn weights (`models.variants.FNO2dBayesian.sample_head`)
reach K5 and, in training, get their gradients from K7.
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels.fno_block import (
    _unpack_spectral,
    fno_block2d_bwd_fused,
    fno_block2d_bwd_plain,
    fno_block2d_fused,
    fno_kernel_limits,
    projection2d_bwd_fused,
    projection2d_bwd_plain,
    projection2d_fused,
)
from .fno import FNO2d, get_grid

__all__ = ["fno2d_forward_fused", "fused_supported", "make_fused_apply",
           "make_fused_train_apply"]


def _limits(model: FNO2d, x_shape, backward: bool = False):
    return fno_kernel_limits(model.width_time, model.step, x_shape[2], x_shape[3],
                             model.modes1, model.modes2, backward,
                             hidden=model.head_width())


def fused_supported(model: FNO2d, x_shape, backward: bool = False) -> bool:
    """Whether kernels K4 and K5 (with `backward`, also K6 and K7) take this
    model at this input shape: a pure function of the configuration and the
    shape (width, step, grid size and modes; see `fno_kernel_limits`), and
    False for a model with dropout, as in cppre."""
    return model.dropout_rate == 0.0 and not _limits(model, x_shape, backward)


def _require_kernels(model: FNO2d, x, backward: bool = False):
    """On a CUDA tensor, raise ValueError naming every kernel limit that
    this model and input shape break. A CPU tensor passes: the wrappers
    take their plain versions there."""
    broken = _limits(model, x.shape, backward) if _build.on_cuda(x) else []
    if broken:
        raise ValueError(f"the FNO kernels do not take this model at input shape "
                         f"{tuple(x.shape)}: " + "; ".join(broken))


def _refuse_dropout(model: FNO2d, what: str):
    """K4's fused block computes the dropout-free block (as cppre's Pallas
    block does), so a model with dropout is refused, with the reason."""
    if model.dropout_rate > 0.0:
        raise ValueError(f"{what}: the model has dropout_rate={model.dropout_rate}, and kernel K4's fused "
                         f"Fourier block assumes dropout-free inference; roll a dropout model "
                         f"out through its own forward")


def _head_layers(model: FNO2d, head):
    """The head's two layers: `head` (e.g. a Bayesian draw) or the model's
    own (`model.head_layers()`)."""
    return head if head is not None else model.head_layers()


def make_fused_apply(model: FNO2d, head=None):
    """`apply_fn(x)` over the fused kernels, the `apply_fn` that
    `train.rollout.autoregressive_rollout` takes (inference only). `head`
    (two layers with .weight and .bias, e.g. `FNO2dBayesian.sample_head`)
    replaces the model's projection layers in K5. On a CUDA tensor a shape
    the kernels do not take raises ValueError; a model with dropout is
    refused everywhere."""
    _refuse_dropout(model, "make_fused_apply")
    fc1, fc2 = _head_layers(model, head)

    def apply_fn(x):
        _require_kernels(model, x)
        return fno2d_forward_fused(model, x, head=(fc1, fc2))

    return apply_fn


def _lift(fc0, x, grid):
    """fc0(cat(x, grid)) as bias + sum_i feature_i * weight[:, i]: one
    elementwise product and add per input feature."""
    w = fc0.weight
    t_in = x.shape[-1]
    out = fc0.bias
    for i in range(t_in + 2):
        f = x[..., i:i + 1] if i < t_in else grid[..., i - t_in:i - t_in + 1]
        out = out + f * w[:, i]
    return out


def _bias_branch(block, grid_c):
    """b(grid): the batch-constant [1, W, V, Nx, Ny] bias branch of a block."""
    return block.b(grid_c).contiguous()


def _chain(model: FNO2d, x, block_fn, head_fn):
    """The FNO2d forward with its six blocks as block_fn(block, z, x3) and
    its head as head_fn(z [B, V, Nx, Ny, W]): lift, blocks with skip adds
    every three, head."""
    grid = get_grid(x.shape, x.device).to(x.dtype)
    h = _lift(model.fc0_time, x, grid).permute(0, 4, 1, 2, 3).contiguous()
    grid_c = grid[:1].permute(0, 4, 1, 2, 3)
    f = model.blocks()

    def blk(i, z):
        return block_fn(f[i], z, _bias_branch(f[i], grid_c))

    x0 = blk(0, h)
    z = blk(1, x0)
    z = blk(2, z) + x0
    x1 = blk(3, z)
    z = blk(4, x1)
    z = blk(5, z) + x1
    return head_fn(z.permute(0, 2, 3, 4, 1).contiguous())          # [B, V, Nx, Ny, W]


@torch.no_grad()
def fno2d_forward_fused(model: FNO2d, x, head=None):
    """[BS, Nvar, Nx, Ny, T_in] -> [BS, Nvar, Nx, Ny, step], the math of
    `model(x)`, with the blocks and the head in kernels K4 and K5 (their
    plain versions for a CPU tensor); `head` as in `make_fused_apply`."""
    _refuse_dropout(model, "fno2d_forward_fused")
    m1, m2 = model.modes1, model.modes2
    fc1, fc2 = _head_layers(model, head)
    return _chain(model, x, lambda blk, z, x3: fno_block2d_fused(z, blk, x3, m1, m2),
                  lambda z: projection2d_fused(z, fc1, fc2))


# ---- training: K4/K5 forward, K6/K7 backward --------------------------------

def _block_params(block):
    """The block's parameters that K6 differentiates, in `_FusedBlock`'s
    argument order (the bias branch `b` is differentiated outside)."""
    return (block.conv.weights1, block.conv.weights2, block.mlp.mlp1.weight,
            block.mlp.mlp1.bias, block.mlp.mlp2.weight, block.mlp.mlp2.bias, block.w.weight,
            block.w.bias)


# the backward of each block and of the head, by `make_fused_train_apply`'s
# bwd_impl: the kernels K6 and K7, or autograd of the plain math
_BLOCK_BWD = {"pallas": fno_block2d_bwd_fused, "xla": fno_block2d_bwd_plain}
_HEAD_BWD = {"pallas": projection2d_bwd_fused, "xla": projection2d_bwd_plain}


class _FusedBlock(torch.autograd.Function):
    """One Fourier block: forward K4, backward K6 (or autograd of the block
    math, `bwd_impl` 'xla'). The parameters are inputs so that autograd
    hands them their gradients; both passes read them from `block` itself,
    which the optimizer changes only after the backward."""

    @staticmethod
    def forward(ctx, z, x3, block, m1, m2, bwd_impl, *params):
        ctx.save_for_backward(z, x3)
        ctx.block, ctx.modes, ctx.bwd_impl = block, (m1, m2), bwd_impl
        return fno_block2d_fused(z, block, x3, m1, m2)

    @staticmethod
    def backward(ctx, g):
        z, x3 = ctx.saved_tensors
        m1, m2 = ctx.modes
        dx, dwr, dwi, da1, db1, da2, db2, daw, dbw, dx3 = _BLOCK_BWD[ctx.bwd_impl](
            z, g.contiguous(), ctx.block, x3, m1, m2)
        dw1, dw2 = _unpack_spectral(dwr, dwi, m1)
        shape = ctx.block.w.weight.shape                        # [W, W, 1, 1, 1]
        return (dx, dx3, None, None, None, None, dw1, dw2, da1.reshape(shape), db1,
                da2.reshape(shape), db2, daw.reshape(shape), dbw)


class _FusedProjection(torch.autograd.Function):
    """The projection head: forward K5, backward K7 (or autograd of the
    head's math, `bwd_impl` 'xla')."""

    @staticmethod
    def forward(ctx, z, fc1, fc2, bwd_impl, *params):
        ctx.save_for_backward(z)
        ctx.fcs, ctx.bwd_impl = (fc1, fc2), bwd_impl
        return projection2d_fused(z, fc1, fc2)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        dz, da1, db1, da2, db2 = _HEAD_BWD[ctx.bwd_impl](z, g.contiguous(), *ctx.fcs)
        return dz, None, None, None, da1, db1, da2, db2


def make_fused_train_apply(model: FNO2d, bwd_impl: str = "pallas"):
    """A differentiable `apply_fn(x, head=None)` over the kernels, for
    `train.loops`: every block forward (including the recompute of a
    checkpointed step) runs K4 and the head K5. The backward is `bwd_impl`'s,
    with cppre's meaning: 'pallas' (the default) the kernels K6 and K7,
    'xla' autograd of the plain block and head math (`fno_block2d_bwd_plain`,
    `projection2d_bwd_plain`); any other value raises ValueError. `head`
    (two layers with .weight and .bias, e.g. a Bayesian draw that is a
    function of the variational parameters) replaces the model's projection
    layers: K7 returns the gradients of its weights and autograd carries them
    on. On a CPU tensor every kernel takes its plain version. On a CUDA
    tensor a shape the kernels do not take raises ValueError; a model with
    dropout is refused everywhere."""
    if bwd_impl not in _BLOCK_BWD:
        raise ValueError(f"bwd_impl must be one of {tuple(_BLOCK_BWD)}, got {bwd_impl!r}")
    _refuse_dropout(model, "make_fused_train_apply")
    m1, m2 = model.modes1, model.modes2

    def block_fn(blk, z, x3):
        return _FusedBlock.apply(z, x3, blk, m1, m2, bwd_impl, *_block_params(blk))

    def apply_fn(x, head=None):
        _require_kernels(model, x, backward=True)
        fc1, fc2 = _head_layers(model, head)
        return _chain(model, x, block_fn,
                      lambda z: _FusedProjection.apply(z, fc1, fc2, bwd_impl, fc1.weight,
                                                       fc1.bias, fc2.weight, fc2.bias))

    return apply_fn
