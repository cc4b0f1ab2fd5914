"""Stencil operators, the FFT operators, boundary padding, vector calculus
and the hand-written kernels (`ops.kernels`)."""

from .boundary import BoundaryManager
from .convops import (
    ConvOperator,
    ConvOperator0d,
    ConvOperator1d,
    ConvOperator2d,
    ConvOperatorSpatial,
    direct_conv,
    stencil_shift_add,
)
from .fftconv import (FFTConv, FFTConv1d, FFTConv2d, FFTConv3d, fft_conv,
                      spectral_differentiate, spectral_integrate)
from .findiff_matrix import finite_difference_matrix_1d, finite_difference_matrix_2d
from .stencils import embed_kernel_3d, stencil_1d, stencil_2d, stencil_time_space

__all__ = [
    "BoundaryManager",
    "ConvOperator",
    "ConvOperator0d",
    "ConvOperator1d",
    "ConvOperator2d",
    "ConvOperatorSpatial",
    "direct_conv",
    "stencil_shift_add",
    "fft_conv",
    "spectral_differentiate",
    "spectral_integrate",
    "FFTConv",
    "FFTConv1d",
    "FFTConv2d",
    "FFTConv3d",
    "finite_difference_matrix_1d",
    "finite_difference_matrix_2d",
    "embed_kernel_3d",
    "stencil_1d",
    "stencil_2d",
    "stencil_time_space",
]
