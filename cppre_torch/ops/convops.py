"""The ConvOperator family: finite-difference stencils as convolution
kernels, in torch.

Port of `cppre.ops.convops`. The API is the JAX package's:
``ConvOperator*(domain, order, scale, taylor_order, conv)`` with a mutable,
*additive* NumPy ``.kernel``, so a whole PDE operator composes into one
kernel (``D.kernel = D_t.kernel + c * D_x.kernel``).

``conv='direct'`` applies a constant (NumPy) kernel as a **shift-add**: one
shifted-slice multiply-add per non-zero tap over the zero-padded field, in
tap order, the same arithmetic as `cppre.ops.convops.stencil_shift_add`. A
kernel given as a torch tensor (a learnable stencil) goes through
``F.convNd`` with cuDNN's TF32 switched off, so float32 results stay
float32. ``conv='spectral'`` takes `fftconv.fft_conv`; `differentiate` and
`integrate` take `fftconv.spectral_differentiate` / `spectral_integrate`.

Data layouts:
  ConvOperator0d      : [BS, Nt]              kernel 1-D
  ConvOperator1d      : [BS, Nt, Nx]          kernel 2-D
  ConvOperator2d      : [BS, Nt, Nx, Ny]      kernel 3-D, ordered [t, x, y]
  ConvOperatorSpatial : [BS, C, Nx, Ny]       kernel 2-D, *valid* convolution
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from . import fftconv
from .stencils import embed_kernel_3d, stencil_1d, stencil_time_space

__all__ = ["ConvOperator0d", "ConvOperator1d", "ConvOperator2d", "ConvOperator",
           "ConvOperatorSpatial", "direct_conv", "stencil_shift_add"]


def stencil_shift_add(field: torch.Tensor, kernel: np.ndarray, same: bool = True) -> torch.Tensor:
    """Cross-correlate `field` [B, *spatial] with a constant stencil.

    Equivalent to ``F.convNd(padding=k//2)`` (same) or a valid convolution
    (same=False); cost is one read of the field per non-zero tap.
    """
    kernel = np.asarray(kernel)
    nd = kernel.ndim
    spatial = field.shape[-nd:]
    if same:
        pads = []
        for k in reversed(kernel.shape):
            pads += [k // 2, k // 2]
        padded = F.pad(field, pads)
        out_shape = tuple(spatial)
    else:
        padded = field
        out_shape = tuple(s - k + 1 for s, k in zip(spatial, kernel.shape))

    taps = [(idx, kernel[idx]) for idx in itertools.product(*(range(k) for k in kernel.shape))
            if kernel[idx] != 0]
    if not taps:
        return field.new_zeros(field.shape[: field.ndim - nd] + out_shape)

    lead = (slice(None),) * (field.ndim - nd)
    acc = None
    for idx, w in taps:
        window = padded[lead + tuple(slice(i, i + o) for i, o in zip(idx, out_shape))]
        term = window * float(np.float32(w))
        acc = term if acc is None else acc + term
    return acc


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def direct_conv(field: torch.Tensor, kernel, same: bool = True) -> torch.Tensor:
    """Cross-correlate `field` [B, *spatial] with `kernel` [*k_spatial].

    A NumPy kernel takes the shift-add; a torch tensor kernel (learnable)
    takes ``F.convNd`` with TF32 off, so the float32 result matches the CPU
    to ~1e-6.
    """
    if not isinstance(kernel, torch.Tensor):
        return stencil_shift_add(field, np.asarray(kernel), same=same)
    nd = kernel.ndim
    lead = field.shape[: field.ndim - nd]
    lhs = field.reshape((-1, 1) + tuple(field.shape[-nd:]))
    rhs = kernel[None, None].to(device=lhs.device, dtype=lhs.dtype)
    padding = tuple(k // 2 for k in kernel.shape) if same else 0
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = _CONV[nd](lhs, rhs, padding=padding)
    return out[:, 0].reshape(lead + out.shape[2:])


class _ConvOperatorBase:
    """Shared machinery: the direct / spectral dispatch and the spectral
    paths. ``kernel`` is mutable and additive: build per-term operators,
    then compose ``D.kernel = D_t.kernel + c * D_x.kernel`` on a bare
    operator."""

    _ndim: int = 1  # kernel rank
    # the reference's defaults differ by rank (ConvOperator0d's integrate
    # crops and does not pad)
    _integrate_slice_pad_default = False
    _integrate_pad = True

    def __init__(self, kernel=None, conv: str = "direct"):
        self.kernel = kernel
        if conv == "direct":
            self.conv = self.convolution
        elif conv == "spectral":
            self.conv = self.spectral_convolution
        else:
            raise ValueError("Unknown Convolution Method")
        self._conv_name = conv

    def _bc(self, field):
        """Add a channel axis -> [B, 1, *spatial] for the FFT paths."""
        if field.ndim == self._ndim + 1:
            return field[:, None], True
        return field, False

    def convolution(self, field, kernel=None):
        if kernel is not None:
            self.kernel = kernel
        return direct_conv(field, self.kernel, same=True)

    def spectral_convolution(self, field, kernel=None, inverse=False):
        if kernel is not None:
            self.kernel = kernel
        f, squeezed = self._bc(field)
        k = fftconv._as_f32(self.kernel, field.device)[None, None]
        pad = tuple(s // 2 for s in k.shape[2:])
        out = fftconv.fft_conv(f, k, padding=pad, inverse=inverse)
        return out[:, 0] if squeezed else out

    def differentiate(self, field, kernel=None, correlation=False, slice_pad=True, vector=None):
        if kernel is not None:
            self.kernel = kernel
        f, squeezed = self._bc(field)
        out = fftconv.spectral_differentiate(f, self.kernel, correlation, slice_pad,
                                             vector=vector)
        return out[:, 0] if squeezed else out

    def integrate(self, field, kernel=None, correlation=False, slice_pad=None, eps=1e-6):
        if kernel is not None:
            self.kernel = kernel
        if slice_pad is None:
            slice_pad = self._integrate_slice_pad_default
        f, squeezed = self._bc(field)
        out = fftconv.spectral_integrate(f, self.kernel, correlation, slice_pad, eps,
                                         pad=self._integrate_pad)
        return out[:, 0] if squeezed else out

    def forward(self, field):
        return self.conv(field, self.kernel)

    def __call__(self, inputs):
        return self.forward(inputs)


class ConvOperator0d(_ConvOperatorBase):
    """Temporal operator for ODE data [BS, Nt].

    `integrate` does not pad and crops (slice_pad=True) by default, as the
    reference's does, so ``integrate(differentiate(u))`` trims k//2 cells a
    side."""

    _ndim = 1
    _integrate_slice_pad_default = True
    _integrate_pad = False

    def __init__(self, order=None, scale=1.0, taylor_order=2, conv="direct", requires_grad=False):
        kernel = None
        if order is not None:
            kernel = scale * stencil_1d(order, taylor_order)
            self.stencil = kernel
        super().__init__(kernel=kernel, conv=conv)
        self.order = order


class ConvOperator1d(_ConvOperatorBase):
    """Operator on 1-space + time data [BS, Nt, Nx]: domain 't' (or
    ('x', 't'), the 2-D Laplacian) differentiates along rows (time), 'x'
    transposes the stencil."""

    _ndim = 2

    def __init__(self, domain=None, order=None, scale=1.0, taylor_order=2, conv="direct"):
        kernel = None
        if domain is not None:
            stencil = stencil_time_space(len(domain), order, taylor_order)
            if domain == "t" or domain == ("x", "t"):
                pass
            elif domain == "x":
                stencil = stencil.T
            else:
                raise ValueError("Invalid Domain. Must be either x or t")
            self.stencil = stencil
            kernel = scale * stencil
        super().__init__(kernel=kernel, conv=conv)
        self.domain = domain
        self.order = order


class ConvOperator2d(_ConvOperatorBase):
    """Operator on 2-space + time data [BS, Nt, Nx, Ny].

    Kernel dims are ordered [t, x, y]; the 2-D stencil is embedded in the
    central plane selected by the domain:
      't' -> plane kernel[:, :, c]   'x' -> plane kernel[c, :, :]
      'y' -> plane kernel[:, c, :]   ('x','y') / ('x','y','t') -> axis 0.

    Invalid (domain, order) combinations leave the kernel unset (a bare
    operator whose kernel the caller composes), as in `cppre`.
    """

    _ndim = 3

    def __init__(self, domain=None, order=None, scale=1.0, taylor_order=2, conv="direct",
                 requires_grad=False, legacy_y_axis=False):
        kernel = None
        if domain is not None:
            axis_map = {"t": 2, "x": 0, "y": 1, ("x", "y"): 0, ("x", "y", "t"): 0}
            if domain not in axis_map:
                raise ValueError("Invalid Domain. Must be either x,y or t")
            self.axis = axis_map[domain]
            try:
                stencil = stencil_time_space(min(len(domain), 2), order, taylor_order)
                self.stencil = stencil
                kernel = scale * embed_kernel_3d(stencil, self.axis, legacy_y_axis)
            except ValueError:
                pass  # bare operator; caller composes .kernel additively
        super().__init__(kernel=kernel, conv=conv)
        self.domain = domain
        self.order = order


# The operator class every 2-D experiment uses keeps the reference name.
ConvOperator = ConvOperator2d


class ConvOperatorSpatial(_ConvOperatorBase):
    """Purely spatial operator on [BS, C, Nx, Ny].

    Unlike the time-space operators: a *valid* convolution; the
    first-derivative stencil is divided by 2; an optional `BoundaryManager`
    pads before the convolution; and ``scale`` multiplies the kernel. The
    scale is a float32 tensor: one with ``requires_grad`` (a learnable
    scale) takes `direct_conv`'s tensor-kernel path (``F.convNd``, TF32
    off) and differentiates into the scale; otherwise the scaled kernel is
    a constant and takes the shift-add, as in `cppre`."""

    _ndim = 2

    def __init__(self, domain=("x", "y"), order=1, scale=1.0, taylor_order=2,
                 conv="direct", boundary=None):
        if isinstance(domain, str):
            stencil = stencil_time_space(1, order, taylor_order)
            if order == 1:
                stencil = stencil / np.float32(2.0)  # pre-divided first derivative
            if domain == "x":
                pass  # derivative along rows (Nx)
            elif domain == "y":
                stencil = stencil.T
            else:
                raise ValueError("Invalid Domain. Must be x, y or ('x','y')")
        elif tuple(domain) == ("x", "y"):
            stencil = stencil_time_space(2, order, taylor_order)
        else:
            raise ValueError("Invalid Domain. Must be x, y or ('x','y')")
        self.stencil = stencil
        self.scale = (scale if isinstance(scale, torch.Tensor)
                      else torch.tensor(scale, dtype=torch.float32))
        self.boundary = boundary
        super().__init__(kernel=stencil, conv=conv)
        self.domain = domain
        self.order = order

    def _scaled_kernel(self, device):
        if self.scale.requires_grad or isinstance(self.kernel, torch.Tensor):
            return self.scale.to(device) * fftconv._as_f32(self.kernel, device)
        return np.float32(self.scale.item()) * np.asarray(self.kernel, dtype=np.float32)

    def convolution(self, field, kernel=None):
        if kernel is not None:
            self.kernel = kernel
        k = self._scaled_kernel(field.device)
        if self.boundary is not None:
            field = self.boundary.pad(field)
        # channels are independent: fold C into the batch for the convolution
        b, c = field.shape[0], field.shape[1]
        out = direct_conv(field.reshape((b * c,) + tuple(field.shape[2:])), k, same=False)
        return out.reshape((b, c) + tuple(out.shape[1:]))
