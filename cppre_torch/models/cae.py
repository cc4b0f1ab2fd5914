"""Conditional convolutional auto-encoder for Grad-Shafranov surrogates.

Port of `cppre.models.cae.ConvAutoencoder`: encode the (R, Z) coordinate
grid with three stride-2 convolutions, bottleneck through a dense layer,
concatenate the PF-coil parameter vector, decode with three stride-2
transposed convolutions and a 1x1 convolution to psi(R, Z).

It computes what flax computes, in three places where the obvious torch
layer would not:
* a stride-2 convolution with SAME padding pads (lo, hi) with the extra
  cell on the high side (for a 64 input: (0, 1)), so the padding is an
  explicit `F.pad` before an unpadded `conv2d`;
* flax's `ConvTranspose` (`transpose_kernel=False`) is `lax.conv_transpose`:
  the input dilated by the stride, padded (2, 1) for k=3, s=2, and
  correlated with the kernel as it is stored. Here that is
  `conv_transpose2d` of the kernel flipped in space, padded evenly to the
  larger side, then cropped to the smaller;
* the bottleneck flattens channels-last (H, W, C), as flax's reshape of
  NHWC does, so the dense weights carry over unpermuted.

Weights are torch-shaped (convs [out, in, kh, kw], transposed convs
[in, out, kh, kw] as stored by flax, dense [out, in]); `utils.jax_params.
cae_from_jax` loads a flax tree. Random init follows flax's (LeCun normal
kernels, zero biases), drawn from an explicit `torch.Generator` on the CPU,
then moved to `device` (the card by default).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ConvAutoencoder"]

_K, _S = 3, 2  # kernel and stride of every down/up-sampling layer


def _lecun_normal(t, fan_in, generator=None):
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (rescaled so the truncated variance is
    1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _same_pads(n, k=_K, s=_S):
    """SAME padding of a strided convolution: out = ceil(n/s) and the
    (lo, hi) pads that give it, the odd cell on the high side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pads(k=_K, s=_S):
    """`lax.conv_transpose`'s SAME padding of the dilated input."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    return lo, pad_len - lo


class _Conv(nn.Module):
    """flax `nn.Conv` (HWIO kernel, SAME padding, optional stride) on NCHW."""

    def __init__(self, cin, cout, k, stride=1, generator=None):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(_lecun_normal(torch.empty(cout, cin, k, k), cin * k * k,
                                                 generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        if self.k > 1 or self.stride > 1:
            (hl, hh), (wl, wh) = (_same_pads(n, self.k, self.stride) for n in x.shape[-2:])
            x = F.pad(x, (wl, wh, hl, hh))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class _ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` (k=3, stride 2, SAME, untransposed kernel) on
    NCHW: the output is stride x the input."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        # flax stores [kh, kw, in, out]; kept as [in, out, kh, kw]
        self.weight = nn.Parameter(_lecun_normal(torch.empty(cin, cout, _K, _K),
                                                 cin * _K * _K, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        lo, hi = _transpose_pads()
        e = max(lo, hi)
        # conv_transpose2d pads the dilated input by k-1-padding a side and
        # correlates with the flipped kernel: flip it back, pad e a side,
        # then crop each side down to (lo, hi)
        y = F.conv_transpose2d(x, torch.flip(self.weight, (-2, -1)), self.bias, stride=_S,
                               padding=_K - 1 - e)
        return y[..., e - lo:y.shape[-2] - (e - hi), e - lo:y.shape[-1] - (e - hi)]


class _Dense(nn.Module):
    """flax `nn.Dense` with torch's [out, in] weight layout."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_lecun_normal(torch.empty(cout, cin), cin, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ConvAutoencoder(nn.Module):
    """(coords [B, 2, N, N], params [B, n_params]) -> psi [B, 1, N', N'].

    N' = N for N a multiple of 8; for other N the three halvings round up
    and the three doublings do not, as in `cppre` (33 -> 5 -> 40). The
    bottleneck's size depends on N, so the grid is fixed at construction."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1, n_params: int = 12,
                 latent: int = 256, base: int = 16, grid=(64, 64), *, device="cuda",
                 generator=None):
        super().__init__()
        g = generator
        self.n_params, self.latent, self.base = n_params, latent, base
        chans = [in_channels] + [base * m for m in (1, 2, 4)]
        self.enc = nn.ModuleList(_Conv(chans[i], chans[i + 1], _K, _S, g) for i in range(3))
        h, w = grid
        for _ in range(3):
            h, w = -(-h // _S), -(-w // _S)
        self.enc_shape = (h, w, chans[-1])                      # NHWC, as flax flattens
        n_enc = h * w * chans[-1]
        self.fc_in = _Dense(n_enc, latent, g)
        self.fc_out = _Dense(latent + n_params, n_enc, g)
        dec = [chans[-1]] + [base * m for m in (2, 1, 1)]
        self.dec = nn.ModuleList(_ConvTranspose(dec[i], dec[i + 1], g) for i in range(3))
        self.head = _Conv(dec[-1], out_channels, 1, 1, g)
        self.to(device)

    def forward(self, coords, params):
        x = coords
        for conv in self.enc:
            x = F.relu(conv(x))
        b = x.shape[0]
        x = F.relu(self.fc_in(x.permute(0, 2, 3, 1).reshape(b, -1)))
        x = F.relu(self.fc_out(torch.cat([x, params], dim=-1)))
        x = x.reshape((b,) + self.enc_shape).permute(0, 3, 1, 2)
        for deconv in self.dec:
            x = F.relu(deconv(x))
        return self.head(x)
