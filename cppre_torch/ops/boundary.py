"""Boundary-condition padding for stencil convolutions (port of
`cppre.ops.boundary`).

Each of the four sides of a [B, C, H, W] field gets its own condition; the
padded field is then convolved *valid*, so the condition sets the ghost
cells:
  dirichlet             -> constant pad with the side's value
  neumann / outflow     -> replicate (zero gradient)
  periodic              -> wrap (pull from the opposite side)
  symmetric / free_slip -> reflect (excluding the edge sample)
Sides are padded in turn, left, right, top, bottom, so a periodic side
wraps the *already padded* perpendicular extent, as in `cppre`. The pads
gather by `numpy.pad`'s indices (`fftconv.pad_axis`), so they work at any
rank and copy values exactly.
"""

from __future__ import annotations

from .fftconv import pad_axis

__all__ = ["BoundaryManager"]

SUPPORTED_TYPES = [
    "dirichlet",
    "neumann",
    "periodic",
    "symmetric",
    "free_slip",
    "outflow",
]

_SIDES = ("left", "right", "top", "bottom")
_MODES = {"dirichlet": "constant", "neumann": "edge", "outflow": "edge",
          "symmetric": "reflect", "free_slip": "reflect", "periodic": "wrap"}


class BoundaryManager:
    """Per-side boundary padding for 2-D fields."""

    SUPPORTED_TYPES = SUPPORTED_TYPES

    def __init__(self, kernel_size):
        if isinstance(kernel_size, int):
            kh = kw = kernel_size
        else:
            kh, kw = kernel_size
        self.kernel_height, self.kernel_width = kh, kw
        self.pad_left = self.pad_right = kw // 2
        self.pad_top = self.pad_bottom = kh // 2
        self.boundary_types = {s: "periodic" for s in _SIDES}
        self.boundary_values = {s: 0.0 for s in _SIDES}

    def set_boundary_type(self, side, bc_type, value=0.0):
        if side not in _SIDES:
            raise ValueError(f"Unknown side: {side}. Use 'left', 'right', 'top', or 'bottom'")
        if bc_type.lower() not in SUPPORTED_TYPES:
            raise ValueError(f"Unsupported boundary type: {bc_type}")
        self.boundary_types[side] = bc_type.lower()
        self.boundary_values[side] = value

    def set_all_boundaries(self, bc_type, value=0.0):
        for side in _SIDES:
            self.set_boundary_type(side, bc_type, value)

    def _pad_one(self, x, side, amount):
        """Pad one side of the trailing [H, W] axes of `x` [..., H, W]."""
        if amount <= 0:
            return x
        axis = -1 if side in ("left", "right") else -2
        before, after = (amount, 0) if side in ("left", "top") else (0, amount)
        return pad_axis(x, axis, before, after, _MODES[self.boundary_types[side]],
                        float(self.boundary_values[side]))

    def pad_signal(self, signal):
        """Pad [B, C, H, W] (or [H, W]) according to the configured BCs."""
        x = signal
        x = self._pad_one(x, "left", self.pad_left)
        x = self._pad_one(x, "right", self.pad_right)
        x = self._pad_one(x, "top", self.pad_top)
        x = self._pad_one(x, "bottom", self.pad_bottom)
        return x

    # alias used by ConvOperatorSpatial
    pad = pad_signal

    def apply_convolution(self, signal, kernel):
        """Pad, then *valid*-convolve."""
        from .convops import direct_conv

        squeeze = signal.ndim == 2
        x = signal[None] if squeeze else signal
        padded = self.pad_signal(x)
        if padded.ndim == 4:  # [B, C, H, W] -> fold C into the batch
            b, c = padded.shape[:2]
            out = direct_conv(padded.reshape((b * c,) + tuple(padded.shape[2:])), kernel,
                              same=False)
            out = out.reshape((b, c) + tuple(out.shape[1:]))
        else:
            out = direct_conv(padded, kernel, same=False)
        return out[0] if squeeze else out
