"""rFFT-based convolution and deconvolution, in torch (port of
`cppre.ops.fftconv`).

The behaviour is the JAX package's, which follows the reference's modified
`fft-conv-pytorch`:

* the kernel spectrum is conjugated, so the "convolution" is a
  cross-correlation, as `F.convNd` computes it;
* the signal's last axis is padded to even length before the one-sided
  rFFT, and the output is cropped by the size before that pad;
* `inverse=True` replaces the kernel spectrum with ``1/(K + eps)`` (after
  the conjugation), the deconvolution that inverts residual bounds
  (`ConvOperator*.integrate`).

`_manual_spectral`, the body of the operators' `differentiate` and
`integrate`, zero-pads every spatial axis by k//2, takes no even-length pad,
applies ``1/(K + eps)`` before the conjugation, and calls `irfftn` without
`s=`, so an odd padded length comes back one shorter: all as in `cppre`.

The FFTs run in float32 and complex64 on the tensor's device.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["fft_conv", "spectral_differentiate", "spectral_integrate",
           "FFTConv", "FFTConv1d", "FFTConv2d", "FFTConv3d"]

IntOrTuple = Union[int, float, Sequence[Union[int, float]]]


def _ntuple(val: IntOrTuple, n: int):
    if isinstance(val, (tuple, list)):
        if len(val) != n:
            raise ValueError(f"Cannot cast tuple of length {len(val)} to length {n}.")
        return tuple(val)
    return (val,) * n


def _pad_mode(padding_mode: str) -> str:
    """Padding-mode name -> `numpy.pad` mode (the JAX package's `jnp.pad`)."""
    return {
        "constant": "constant",
        "reflection": "reflect",
        "reflect": "reflect",
        "replication": "edge",
        "replicate": "edge",
    }[padding_mode]


def pad_axis(x: torch.Tensor, axis: int, before: int, after: int, mode: str = "constant",
             value: float = 0.0) -> torch.Tensor:
    """Pad one axis of `x` as `numpy.pad` does with `mode` ('constant',
    'edge', 'reflect' or 'wrap'), at any rank. The non-constant modes gather
    along the axis by the indices `numpy.pad` gives `arange(n)`, so corners
    and pads wider than the axis follow numpy exactly."""
    if before == 0 and after == 0:
        return x
    axis = axis % x.ndim
    if mode == "constant":
        pads = [0, 0] * (x.ndim - 1 - axis) + [before, after]
        return F.pad(x, pads, mode="constant", value=value)
    idx = np.pad(np.arange(x.shape[axis]), (before, after), mode=mode)
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def _pad_spatial(x: torch.Tensor, pads, mode: str = "constant") -> torch.Tensor:
    """`jnp.pad(x, [(0, 0), (0, 0)] + pads, mode)`: pads the axes after the
    first two, in order, as numpy does."""
    for i, (lo, hi) in enumerate(pads):
        x = pad_axis(x, 2 + i, lo, hi, mode)
    return x


def _dilate_kernel(kernel: torch.Tensor, dilation: tuple) -> torch.Tensor:
    """Insert dilation-1 zeros between kernel taps."""
    if all(d == 1 for d in dilation):
        return kernel
    new_shape = tuple(kernel.shape[:2]) + tuple(
        (k - 1) * d + 1 for k, d in zip(kernel.shape[2:], dilation))
    out = kernel.new_zeros(new_shape)
    out[(slice(None), slice(None)) + tuple(slice(None, None, d) for d in dilation)] = kernel
    return out


def _as_f32(a, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def fft_conv(signal: torch.Tensor, kernel, bias=None, padding: IntOrTuple | str = 0,
             padding_mode: str = "constant", stride: IntOrTuple = 1, dilation: IntOrTuple = 1,
             groups: int = 1, inverse: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """N-d FFT cross-correlation of `signal` [B, C_in, *spatial] with
    `kernel` [C_out, C_in/groups, *k_spatial]; `inverse=True` deconvolves.

    `groups` has the `F.convNd` meaning: channels split into `groups`
    blocks, each output block contracting only its input block."""
    n = signal.ndim - 2
    stride_ = _ntuple(stride, n)
    dilation_ = _ntuple(dilation, n)
    kernel = _as_f32(kernel, signal.device)
    if isinstance(padding, str):
        if padding != "same":
            raise ValueError(f"Padding mode {padding} not supported.")
        if any(s != 1 for s in stride_) or any(d != 1 for d in dilation_):
            raise ValueError("stride must be 1 for padding='same'.")
        padding_ = tuple((k - 1) / 2 for k in kernel.shape[2:])
    else:
        padding_ = _ntuple(padding, n)

    kernel = _dilate_kernel(kernel, dilation_)

    # floor on the left, ceil on the right
    signal = _pad_spatial(signal, [(math.floor(p), math.ceil(p)) for p in padding_],
                          _pad_mode(padding_mode))
    signal_size = signal.shape  # the size before the even pad drives the crop
    if signal.shape[-1] % 2 != 0:
        signal = F.pad(signal, [0, 1])

    kpads = []
    for i in reversed(range(2, signal.ndim)):
        kpads += [0, signal.shape[i] - kernel.shape[i]]
    padded_kernel = F.pad(kernel, kpads)

    dims = tuple(range(2, signal.ndim))
    signal_fr = torch.fft.rfftn(signal.float(), dim=dims)
    kernel_fr = torch.fft.rfftn(padded_kernel, dim=dims)

    kernel_fr = torch.conj(kernel_fr).resolve_conj()  # correlation (matches direct conv)
    if inverse:
        kernel_fr = 1.0 / (kernel_fr + eps)

    c_out, c_in_pg = kernel.shape[0], kernel.shape[1]
    if groups == 1 and c_out == 1 and c_in_pg == 1:
        output_fr = signal_fr * kernel_fr[:, 0]
    elif groups == 1:
        output_fr = torch.sum(signal_fr[:, None] * kernel_fr[None], dim=2)   # [B, C_out, *f]
    else:
        c_in = signal_fr.shape[1]
        if c_in % groups or c_out % groups or c_in // groups != c_in_pg:
            raise ValueError(f"groups={groups} incompatible with C_in={c_in}, "
                             f"kernel {tuple(kernel.shape[:2])}")
        freq = tuple(signal_fr.shape[2:])
        sf = signal_fr.reshape((signal_fr.shape[0], groups, c_in_pg) + freq)
        kf = kernel_fr.reshape((groups, c_out // groups, c_in_pg) + freq)
        # [B, g, 1, cpg, ...] * [1, g, opg, cpg, ...] summed over cpg
        output_fr = torch.sum(sf[:, :, None] * kf[None], dim=3)
        output_fr = output_fr.reshape((signal_fr.shape[0], c_out) + freq)
    output = torch.fft.irfftn(output_fr, dim=dims)

    crop = (slice(None), slice(None)) + tuple(
        slice(0, signal_size[i] - kernel.shape[i] + 1, stride_[i - 2])
        for i in range(2, signal.ndim))
    output = output[crop]

    if bias is not None:
        output = output + _as_f32(bias, output.device).reshape((1, -1) + (1,) * n)
    return output


def _manual_spectral(field: torch.Tensor, kernel, correlation: bool, slice_pad: bool,
                     inverse: bool, eps: float, pad: bool, vector=None) -> torch.Tensor:
    """Shared body of the operators' `differentiate` and `integrate`.

    `field` is [B, C, *spatial]; `kernel` is [*k_spatial]. Every spatial
    axis is zero-padded by k//2 on both sides (`pad=False` keeps the field
    as it is, ConvOperator0d.integrate's rule). `vector` ([*spatial],
    [B, *spatial] or the field's rank) multiplies in Fourier space: the
    variable-coefficient term, e.g. x * dy/dx."""
    n = field.ndim - 2
    kernel = _as_f32(kernel, field.device)
    p = kernel.shape[-1] // 2
    padded = F.pad(field, [p, p] * n) if pad else field

    dims = tuple(range(2, field.ndim))
    field_fft = torch.fft.rfftn(padded.float(), dim=dims)

    k = kernel.reshape((1, 1) + tuple(kernel.shape))
    kpads = []
    for i in reversed(range(2, padded.ndim)):
        kpads += [0, padded.shape[i] - k.shape[i]]
    kernel_fft = torch.fft.rfftn(F.pad(k, kpads), dim=dims)

    if inverse:
        kernel_fft = 1.0 / (kernel_fft + eps)
    if correlation:
        kernel_fft = torch.conj(kernel_fft).resolve_conj()

    if vector is not None:
        vec = _as_f32(vector, field.device)
        if vec.ndim == field.ndim - 2:      # [*spatial] -> [1, 1, *spatial]
            vec = vec[None, None]
        elif vec.ndim == field.ndim - 1:    # [B, *spatial] -> [B, 1, *spatial]
            vec = vec[:, None]
        elif vec.ndim != field.ndim:
            raise ValueError(f"vector rank {vec.ndim} incompatible with field rank "
                             f"{field.ndim}")
        if pad:
            vec = F.pad(vec, [p, p] * n)
        kernel_fft = kernel_fft * torch.fft.rfftn(vec, dim=dims)

    output = torch.fft.irfftn(field_fft * kernel_fft, dim=dims)

    if slice_pad:
        crop = (slice(None), slice(None)) + tuple(
            slice(0, padded.shape[i] - k.shape[i] + 1) for i in range(2, padded.ndim))
        output = output[crop]
    return output


def spectral_differentiate(field, kernel, correlation=False, slice_pad=True, vector=None):
    """FFT differentiation (the operators' `differentiate`); `vector` gives
    variable-coefficient terms like x * dy/dx."""
    return _manual_spectral(field, kernel, correlation, slice_pad, inverse=False, eps=0.0,
                            pad=True, vector=vector)


def spectral_integrate(field, kernel, correlation=False, slice_pad=False, eps=1e-6, pad=True):
    """FFT deconvolution: recover u from D(u) (the operators' `integrate`)."""
    return _manual_spectral(field, kernel, correlation, slice_pad, inverse=True, eps=eps,
                            pad=pad)


class FFTConv(nn.Module):
    """Learnable FFT-convolution layer (`FFTConv1d/2d/3d` fix `ndim`).

    The weight [C_out, C_in/groups, *kernel_size] and the optional bias
    [C_out] are parameters drawn from N(0, 1) with `generator` (a CPU
    `torch.Generator`), then moved to `device`; `forward` runs `fft_conv`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrTuple,
                 padding: IntOrTuple | str = 0, padding_mode: str = "constant",
                 stride: IntOrTuple = 1, dilation: IntOrTuple = 1, groups: int = 1,
                 bias: bool = True, ndim: int = 1, inverse: bool = False, *, device="cuda",
                 generator=None):
        super().__init__()
        if in_channels % groups:
            raise ValueError("'in_channels' must be divisible by 'groups'. "
                             f"Found: in_channels={in_channels}, groups={groups}.")
        if out_channels % groups:
            raise ValueError("'out_channels' must be divisible by 'groups'. "
                             f"Found: out_channels={out_channels}, groups={groups}.")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, ndim)
        self.padding, self.padding_mode = padding, padding_mode
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.use_bias, self.ndim, self.inverse = bias, ndim, inverse
        shape = (out_channels, in_channels // groups) + self.kernel_size
        self.weight = nn.Parameter(torch.randn(shape, generator=generator))
        self.bias = (nn.Parameter(torch.randn(out_channels, generator=generator)) if bias
                     else None)
        self.to(device)

    def forward(self, signal):
        return fft_conv(signal, self.weight, bias=self.bias, padding=self.padding,
                        padding_mode=self.padding_mode, stride=self.stride,
                        dilation=self.dilation, groups=self.groups, inverse=self.inverse)


FFTConv1d = partial(FFTConv, ndim=1)
FFTConv2d = partial(FFTConv, ndim=2)
FFTConv3d = partial(FFTConv, ndim=3)
