"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| kernel | counter (launches of every instance) | instances | replaces |
| K1 | `_joint_cp_diff_stats` | `ns_/wave_/mhd_joint_cp_diff_stats`, the `*_joint_cp_scores_fused` entries | `stencil_kernels._joint_cp_diff_stats` |
| K2 | `_batched_residual_fused` | `ns_momentum_residual_fused`, `mhd_residual_fused` (5 equations), `mhd_induction_residual_fused` | `stencil_kernels._batched_residual_fused` |
| K3 | `_joint_cp_diff_stats_chunked` | `ns_/wave_/mhd_joint_cp_diff_stats_chunked`, the routed K1 entries where `routing_decision` says 'chunked' | `stencil_kernels._joint_cp_diff_stats_chunked` |
| K4 | `fno_block2d_fused` | itself | `fno_block.fno_block2d_fused` |
| K5 | `projection2d_fused` | itself | `fno_block.projection2d_fused` |
| K6 | `fno_block2d_bwd_fused` | itself | `fno_block.fno_block2d_bwd_fused` |
| K7 | `projection2d_bwd_fused` | itself | `fno_block.projection2d_bwd_fused` |
| K8 | `fused_stencil_residual` | itself, `wave_residual_fused` | `stencil_kernels.fused_stencil_residual` |
| K9 | `_joint_cp_scores_single_pass` | `ns_joint_cp_scores_fused`, `mhd_induction_joint_cp_scores_fused` with `single_pass=True` | `stencil_kernels._joint_cp_scores_single_pass` |
| K10 | `_flat_paired_absdiff_stats` | `ns_/mhd_/wave_joint_cp_scores_flat` | `flat_kernels._flat_paired_absdiff_stats` |
| K11 | `_flat_residual_kernel` | the same, where `flat_routing_decision` says 'two_kernel' | `flat_kernels._flat_residual_kernel` |
| K12 | `_flat_absdiff_stats_from_res` | the same, after K11 | `flat_kernels._flat_absdiff_stats_from_res` |

(replaced functions under `cppre/ops/pallas/`; every `pallas_call` site there
has a kernel here). Each public wrapper has a
plain twin named `*_plain`. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. Every kernel counts its launches in
`.launches` on its counter; `launch_counts()` reads them all and
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
from .flat_kernels import (
    _flat_absdiff_stats_from_res,
    _flat_paired_absdiff_stats,
    _flat_residual_kernel,
    flat_routing_decision,
    mhd_joint_cp_scores_flat,
    mhd_joint_cp_scores_flat_plain,
    ns_joint_cp_scores_flat,
    ns_joint_cp_scores_flat_plain,
    wave_joint_cp_scores_flat,
    wave_joint_cp_scores_flat_plain,
)
from .stencil_kernels import (
    MHD_EQUATIONS,
    _batched_residual_fused,
    _joint_cp_diff_stats,
    _joint_cp_diff_stats_chunked,
    _joint_cp_scores_single_pass,
    fused_stencil_residual,
    fused_stencil_residual_plain,
    mhd_induction_joint_cp_scores_fused,
    mhd_induction_joint_cp_scores_plain,
    mhd_induction_residual_fused,
    mhd_joint_cp_diff_stats,
    mhd_joint_cp_diff_stats_chunked,
    mhd_joint_cp_diff_stats_chunked_plain,
    mhd_joint_cp_diff_stats_plain,
    mhd_residual_fused,
    mhd_residual_plain,
    ns_joint_cp_diff_stats,
    ns_joint_cp_diff_stats_chunked,
    ns_joint_cp_diff_stats_chunked_plain,
    ns_joint_cp_diff_stats_plain,
    ns_joint_cp_scores_fused,
    ns_joint_cp_scores_plain,
    ns_momentum_residual_fused,
    ns_momentum_residual_plain,
    routing_decision,
    wave_joint_cp_diff_stats,
    wave_joint_cp_diff_stats_chunked,
    wave_joint_cp_diff_stats_chunked_plain,
    wave_joint_cp_diff_stats_plain,
    wave_joint_cp_scores_fused,
    wave_joint_cp_scores_plain,
    wave_residual_fused,
)

KERNELS = {
    "K1": _joint_cp_diff_stats,
    "K2": _batched_residual_fused,
    "K3": _joint_cp_diff_stats_chunked,
    "K4": fno_block2d_fused,
    "K5": projection2d_fused,
    "K6": fno_block2d_bwd_fused,
    "K7": projection2d_bwd_fused,
    "K8": fused_stencil_residual,
    "K9": _joint_cp_scores_single_pass,
    "K10": _flat_paired_absdiff_stats,
    "K11": _flat_residual_kernel,
    "K12": _flat_absdiff_stats_from_res,
}


def launch_counts() -> dict:
    """{kernel id: launches since the last reset}."""
    return {k: fn.launches for k, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "MHD_EQUATIONS",
    "flat_routing_decision",
    "fno_block2d_bwd_fused",
    "fno_block2d_bwd_plain",
    "fno_block2d_fused",
    "fno_block2d_plain",
    "fno_kernel_limits",
    "fused_stencil_residual",
    "fused_stencil_residual_plain",
    "launch_counts",
    "mhd_induction_joint_cp_scores_fused",
    "mhd_induction_joint_cp_scores_plain",
    "mhd_induction_residual_fused",
    "mhd_joint_cp_diff_stats",
    "mhd_joint_cp_diff_stats_chunked",
    "mhd_joint_cp_diff_stats_chunked_plain",
    "mhd_joint_cp_diff_stats_plain",
    "mhd_joint_cp_scores_flat",
    "mhd_joint_cp_scores_flat_plain",
    "mhd_residual_fused",
    "mhd_residual_plain",
    "ns_joint_cp_diff_stats",
    "ns_joint_cp_diff_stats_chunked",
    "ns_joint_cp_diff_stats_chunked_plain",
    "ns_joint_cp_diff_stats_plain",
    "ns_joint_cp_scores_flat",
    "ns_joint_cp_scores_flat_plain",
    "ns_joint_cp_scores_fused",
    "ns_joint_cp_scores_plain",
    "ns_momentum_residual_fused",
    "ns_momentum_residual_plain",
    "projection2d_bwd_fused",
    "projection2d_bwd_plain",
    "projection2d_fused",
    "projection2d_plain",
    "reset_launch_counts",
    "routing_decision",
    "wave_joint_cp_diff_stats",
    "wave_joint_cp_diff_stats_chunked",
    "wave_joint_cp_diff_stats_chunked_plain",
    "wave_joint_cp_diff_stats_plain",
    "wave_joint_cp_scores_flat",
    "wave_joint_cp_scores_flat_plain",
    "wave_joint_cp_scores_fused",
    "wave_joint_cp_scores_plain",
    "wave_residual_fused",
]
