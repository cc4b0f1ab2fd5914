"""FNO2d surrogate and its paths through the hand-written kernels."""

from .fno import FNO2d, FNO_multi2d, SpectralConv2d, count_params
from .fused import fno2d_forward_fused, fused_supported, make_fused_apply, make_fused_train_apply

__all__ = ["FNO2d", "FNO_multi2d", "SpectralConv2d", "count_params",
           "fno2d_forward_fused", "fused_supported", "make_fused_apply",
           "make_fused_train_apply"]
