"""ConvOperator2d: finite-difference stencils as convolution kernels, in torch.

Port of `cppre.ops.convops` (the 2-D time-space operator and the direct
convolution paths it uses). The API is the JAX package's:
``ConvOperator2d(domain, order, scale, taylor_order, conv)`` with a mutable,
*additive* NumPy ``.kernel``, so a whole PDE operator composes into one
kernel (``D.kernel = D_t.kernel + c * D_x.kernel``).

A constant (NumPy) kernel is applied as a **shift-add**: one shifted-slice
multiply-add per non-zero tap over the zero-padded field, in tap order, the
same arithmetic as `cppre.ops.convops.stencil_shift_add`. A kernel given as
a torch tensor (a learnable stencil) goes through ``F.convNd`` with cuDNN's
TF32 switched off, so float32 results stay float32.

Data layout: ConvOperator2d acts on [BS, Nt, Nx, Ny] with a kernel ordered
[t, x, y].
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .stencils import embed_kernel_3d, stencil_time_space

__all__ = ["ConvOperator2d", "ConvOperator", "direct_conv", "stencil_shift_add"]


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


class ConvOperator2d:
    """Operator on 2-space + time data [BS, Nt, Nx, Ny].

    Kernel dims are ordered [t, x, y]; the 2-D stencil is embedded in the
    central plane selected by the domain:
      't' -> plane kernel[:, :, c]   'x' -> plane kernel[c, :, :]
      'y' -> plane kernel[:, c, :]   ('x','y') / ('x','y','t') -> axis 0.

    Invalid (domain, order) combinations leave the kernel unset (a bare
    operator whose kernel the caller composes), as in `cppre`. Only the
    direct convolution is ported; ``conv='spectral'`` needs the FFT
    operators (`cppre/ops/fftconv.py`), which the port does not have yet.
    """

    def __init__(self, domain=None, order=None, scale=1.0, taylor_order=2, conv="direct",
                 requires_grad=False, legacy_y_axis=False):
        if conv != "direct":
            raise ValueError(f"conv={conv!r}: only 'direct' convolution is ported")
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
        self.kernel = kernel
        self.domain = domain
        self.order = order

    def convolution(self, field, kernel=None):
        if kernel is not None:
            self.kernel = kernel
        return direct_conv(field, self.kernel, same=True)

    def forward(self, field):
        return self.convolution(field)

    __call__ = forward


# The operator class every 2-D experiment uses keeps the reference name.
ConvOperator = ConvOperator2d
