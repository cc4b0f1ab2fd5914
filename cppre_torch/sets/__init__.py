"""Set propagation of residual bounds to solution space (port of
`cppre.sets`).

Per-cell residual intervals propagate through the DFT, a per-frequency
complex multiply and the inverse DFT. All three maps are linear, so the
zonotope pipeline collapses to dense arithmetic: centres follow an
fft/ifft, radii one |Re(.)| contraction with a lag kernel
(`interval_fft.propagate_through_deconvolution`). The object API
(`Zonotope`, `interval_fft`, ...) stays float64 numpy, as in `cppre`; the
propagation runs in float32 torch on a device, the card unless the caller
asks for the CPU. No kernel: `cppre` has no Pallas kernel here either.
"""

from .interval_fft import (complex_prod, interval_fft, inverse_interval_fft,
                           propagate_through_deconvolution, real_interval)
from .pre_set_prop import set_PRE, set_pre_batched
from .zonotope import Zonotope

__all__ = [
    "Zonotope",
    "interval_fft",
    "inverse_interval_fft",
    "complex_prod",
    "real_interval",
    "propagate_through_deconvolution",
    "set_PRE",
    "set_pre_batched",
]
