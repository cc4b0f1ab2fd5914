"""Stencil operators and the hand-written kernels (`ops.kernels`)."""

from .convops import ConvOperator, ConvOperator2d, direct_conv, stencil_shift_add
from .stencils import embed_kernel_3d, stencil_1d, stencil_2d, stencil_time_space

__all__ = [
    "ConvOperator",
    "ConvOperator2d",
    "direct_conv",
    "stencil_shift_add",
    "embed_kernel_3d",
    "stencil_1d",
    "stencil_2d",
    "stencil_time_space",
]
