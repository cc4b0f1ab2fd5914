"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| kernel | wrapper | plain version | replaces |
| K1 | `ns_joint_cp_diff_stats` | `ns_joint_cp_diff_stats_plain` | `stencil_kernels._joint_cp_diff_stats` |
| K2 | `ns_momentum_residual_fused` | `ns_momentum_residual_plain` | `stencil_kernels._batched_residual_fused` |
| K4 | `fno_block2d_fused` | `fno_block2d_plain` | `fno_block.fno_block2d_fused` |
| K5 | `projection2d_fused` | `projection2d_plain` | `fno_block.projection2d_fused` |
| K6 | `fno_block2d_bwd_fused` | `fno_block2d_bwd_plain` | `fno_block.fno_block2d_bwd_fused` |
| K7 | `projection2d_bwd_fused` | `projection2d_bwd_plain` | `fno_block.projection2d_bwd_fused` |

(replaced functions under `cppre/ops/pallas/`). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Every wrapper counts
its kernel launches in `.launches`; `launch_counts()` reads them all and
`reset_launch_counts()` sets them to 0.
"""

from .fno_block import (
    fno_block2d_bwd_fused,
    fno_block2d_bwd_plain,
    fno_block2d_fused,
    fno_block2d_plain,
    fno_kernel_limits,
    projection2d_bwd_fused,
    projection2d_bwd_plain,
    projection2d_fused,
    projection2d_plain,
)
from .stencil_kernels import (
    ns_joint_cp_diff_stats,
    ns_joint_cp_diff_stats_plain,
    ns_joint_cp_scores_fused,
    ns_joint_cp_scores_plain,
    ns_momentum_residual_fused,
    ns_momentum_residual_plain,
)

KERNELS = {
    "K1": ns_joint_cp_diff_stats,
    "K2": ns_momentum_residual_fused,
    "K4": fno_block2d_fused,
    "K5": projection2d_fused,
    "K6": fno_block2d_bwd_fused,
    "K7": projection2d_bwd_fused,
}


def launch_counts() -> dict:
    """{kernel id: launches since the last reset}."""
    return {k: fn.launches for k, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "fno_block2d_bwd_fused",
    "fno_block2d_bwd_plain",
    "fno_block2d_fused",
    "fno_block2d_plain",
    "fno_kernel_limits",
    "launch_counts",
    "ns_joint_cp_diff_stats",
    "ns_joint_cp_diff_stats_plain",
    "ns_joint_cp_scores_fused",
    "ns_joint_cp_scores_plain",
    "ns_momentum_residual_fused",
    "ns_momentum_residual_plain",
    "projection2d_bwd_fused",
    "projection2d_bwd_plain",
    "projection2d_fused",
    "projection2d_plain",
    "reset_launch_counts",
]
