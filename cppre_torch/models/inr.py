"""Conditioned coordinate-network INR for Grad-Shafranov surrogates.

Port of `cppre.models.inr.INR`: psi(R, Z | coil params) as an MLP over the
flattened grid's points, with Fourier positional features ordered
(coordinate, octave) as `cppre` reshapes them, the coil parameters
broadcast to every point, `depth` dense layers of `width` with flax's
default gelu (the tanh approximation) and a dense head to one value.
The call signature matches `ConvAutoencoder`.

Weights are torch-shaped (dense [out, in]); `utils.jax_params.inr_from_jax`
loads a flax tree. Random init follows flax's (LeCun normal kernels, zero
biases) from an explicit `torch.Generator` on the CPU, then moves to
`device` (the card by default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .cae import _Dense

__all__ = ["INR"]


class INR(nn.Module):
    """(coords [B, 2, NR, NZ], params [B, n_params]) -> psi [B, 1, NR, NZ]."""

    def __init__(self, n_params: int = 12, width: int = 128, depth: int = 4, n_freqs: int = 8,
                 *, device="cuda", generator=None):
        super().__init__()
        self.n_params, self.width, self.depth, self.n_freqs = n_params, width, depth, n_freqs
        # 2^k * pi in float32, as cppre builds them
        freqs = (2.0 ** np.arange(n_freqs)).astype(np.float32) * np.pi
        self.register_buffer("freqs", torch.from_numpy(np.asarray(freqs, np.float32)),
                             persistent=False)
        n_in = 2 + 2 * 2 * n_freqs + n_params
        dims = [n_in] + [width] * depth
        self.layers = nn.ModuleList(_Dense(dims[i], dims[i + 1], generator)
                                    for i in range(depth))
        self.head = _Dense(width, 1, generator)
        self.to(device)

    def forward(self, coords, params):
        b, c, nr, nz = coords.shape
        pts = coords.reshape(b, c, nr * nz).transpose(1, 2)        # [B, P, 2]
        ang = pts[..., None] * self.freqs                           # [B, P, 2, F]
        feat = torch.cat([pts, torch.sin(ang).reshape(b, nr * nz, -1),
                          torch.cos(ang).reshape(b, nr * nz, -1)], dim=-1)
        cond = params[:, None, :].expand(b, nr * nz, params.shape[-1])
        x = torch.cat([feat, cond], dim=-1)
        for layer in self.layers:
            x = F.gelu(layer(x), approximate="tanh")
        psi = self.head(x)                                          # [B, P, 1]
        return psi.transpose(1, 2).reshape(b, 1, nr, nz)
