"""Inference-path FNO2d forward through the hand-written kernels.

Port of the inference half of `cppre.models.fused`.
`fno2d_forward_fused(model, x)` computes `model(x)` with each of the six
Fourier blocks evaluated by kernel K4
(`cppre_torch.ops.kernels.fno_block2d_fused`) and the projection head by
kernel K5 (`projection2d_fused`). The lift, the skip adds, the transposes
and the bias branch b(grid) stay plain torch, as they stay XLA in JAX.

The output of a sample does not depend on the batch it is evaluated in:
K4 and K5 work per sample in a fixed order, the skip adds are elementwise,
the bias branch always runs at batch 1, and the lift is written as a sum of
T_in+2 broadcast products, so no library picks a batch-dependent algorithm
for it. Conformal calibration relies on this: calibration and prediction
samples rolled out at different batch sizes stay exchangeable.

Inference only (no autograd); training keeps `model(x)`.
"""

from __future__ import annotations

import torch

from ..ops.kernels.fno_block import fno_block2d_fused, fno_kernel_supported, projection2d_fused
from .fno import FNO2d, get_grid

__all__ = ["fno2d_forward_fused", "fused_supported", "make_fused_apply"]


def fused_supported(model: FNO2d, x_shape) -> bool:
    """Whether the kernels take this model at this input shape: a pure
    function of the configuration and the shape (width, step, grid size
    and modes; see `fno_kernel_supported`)."""
    return fno_kernel_supported(model.width_time, model.step, x_shape[2], x_shape[3],
                                model.modes1, model.modes2)


def make_fused_apply(model: FNO2d):
    """`apply_fn(x)` over the fused kernels, the `apply_fn` that
    `train.rollout.autoregressive_rollout` takes (inference only).
    Unsupported shapes (`fused_supported`) take `model(x)` per call."""

    def apply_fn(x):
        if fused_supported(model, x.shape):
            return fno2d_forward_fused(model, x)
        with torch.no_grad():
            return model(x)

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


@torch.no_grad()
def fno2d_forward_fused(model: FNO2d, x):
    """[BS, Nvar, Nx, Ny, T_in] -> [BS, Nvar, Nx, Ny, step], the math of
    `model(x)`, with the blocks and the head in kernels K4 and K5 (their
    plain versions for a CPU tensor)."""
    m1, m2 = model.modes1, model.modes2
    grid = get_grid(x.shape, x.device).to(x.dtype)
    h = _lift(model.fc0_time, x, grid).permute(0, 4, 1, 2, 3).contiguous()
    grid_c = grid[:1].permute(0, 4, 1, 2, 3)
    f = model.blocks()

    def blk(i, z):
        return fno_block2d_fused(z, f[i], _bias_branch(f[i], grid_c), m1, m2)

    x0 = blk(0, h)
    z = blk(1, x0)
    z = blk(2, z) + x0
    x1 = blk(3, z)
    z = blk(4, x1)
    z = blk(5, z) + x1
    z = z.permute(0, 2, 3, 4, 1).contiguous()          # [B, V, Nx, Ny, W]
    return projection2d_fused(z, model.fc1_time, model.fc2_time)
