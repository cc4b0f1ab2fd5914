"""The FNO surrogates (FNO2d, FNO1d) and FNO2d's paths through the
hand-written kernels."""

from .fno import (FNO1d, FNO2d, FNO_multi1d, FNO_multi2d, SpectralConv1d, SpectralConv2d,
                  count_params)
from .fused import fno2d_forward_fused, fused_supported, make_fused_apply, make_fused_train_apply

__all__ = ["FNO1d", "FNO2d", "FNO_multi1d", "FNO_multi2d", "SpectralConv1d", "SpectralConv2d",
           "count_params",
           "fno2d_forward_fused", "fused_supported", "make_fused_apply",
           "make_fused_train_apply"]
