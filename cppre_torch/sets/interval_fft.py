"""Interval FFT: propagate per-cell intervals through DFT -> complex
multiply -> inverse DFT (port of `cppre.sets.interval_fft`).

The object API stays float64 numpy, bit for bit with `cppre`:
`interval_fft` turns N real intervals into N frequency-domain zonotopes,
`complex_prod` rotates and scales one by a precise complex number,
`inverse_interval_fft` maps back and `real_interval` takes the real
part's interval hull.

`propagate_through_deconvolution` is the same pipeline as dense torch on a
device. Every step is linear, so
    centres:  c_out = ifft(fft(c) * C)
    radii:    rad_k = (1/N) sum_j r_j w[(k - j) mod N],
              w[m] = sum_h |Re(C_h e^{2 pi i h m / N})|,
the radius map one [..., N] x [N, N] product shared by the whole batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .zonotope import Zonotope

__all__ = [
    "interval_fft",
    "inverse_interval_fft",
    "complex_prod",
    "real_interval",
    "propagate_through_deconvolution",
]


def complex_prod(Z: Zonotope, C: complex) -> Zonotope:
    """Multiply a complex-plane zonotope by the precise complex C
    (rotation by arg(C) and scaling by |C|)."""
    scale = abs(C)
    angle = np.arctan2(C.imag, C.real)
    rot = np.array([[np.cos(angle), -np.sin(angle)],
                    [np.sin(angle), np.cos(angle)]])
    return scale * Z.linear_map(rot)


def interval_fft(intervals) -> list[Zonotope]:
    """[(lo, hi)] x N -> N zonotopes, one per frequency. Input k with
    centre c_k and radius r_k contributes the generator
    r_k (cos th, -sin th), th = 2 pi k h / N."""
    intervals = [(float(lo), float(hi)) for lo, hi in intervals]
    c = np.array([(lo + hi) / 2 for lo, hi in intervals])
    r = np.array([(hi - lo) / 2 for lo, hi in intervals])
    N = len(c)
    k = np.arange(N)
    out = []
    c_fft = np.fft.fft(c)
    for h in range(N):
        theta = 2 * np.pi * k * h / N
        gens = np.vstack((r * np.cos(theta), -r * np.sin(theta)))  # [2, N]
        center = np.array([c_fft[h].real, c_fft[h].imag])
        out.append(Zonotope(center, gens))
    return out


def inverse_interval_fft(zonotopes: list[Zonotope]) -> list[Zonotope]:
    """Inverse DFT over complex-plane zonotopes: output k sums every
    frequency's zonotope rotated by +2 pi h k / N, scaled 1/N."""
    N = len(zonotopes)
    out = []
    for k in range(N):
        centers = []
        gen_blocks = []
        for h, Z in enumerate(zonotopes):
            theta = 2 * np.pi * h * k / N
            rot = np.array([[np.cos(theta), -np.sin(theta)],
                            [np.sin(theta), np.cos(theta)]])
            centers.append(rot @ Z.center)
            gen_blocks.append(rot @ Z.generators)
        center = np.sum(centers, axis=0) / N
        gens = np.hstack(gen_blocks) / N
        out.append(Zonotope(center, gens))
    return out


def real_interval(Z: Zonotope):
    """Interval hull of the real (first) coordinate."""
    lo, hi = Z.interval_hull()
    return float(lo[0]), float(hi[0])


def _lag_kernel(C):
    """w[m] = sum_h |Re(C_h e^{2 pi i h m / N})| for complex64 C [N]. The
    phase angle is ((f32(2 pi) m) h) / N in float32, `cppre`'s order of
    operations, so the two packages round it alike."""
    N = C.shape[-1]
    idx = torch.arange(N, device=C.device, dtype=torch.float32)
    angle = (torch.tensor(2 * math.pi, dtype=torch.float32, device=C.device)
             * idx[:, None]) * idx[None, :] / N                       # [m, h]
    phase = torch.polar(torch.ones_like(angle), angle)
    return torch.sum(torch.abs(torch.real(C[None, :] * phase)), dim=1)


def propagate_through_deconvolution(centers, radii, multipliers, device=None):
    """Interval FFT -> per-frequency complex multiply -> inverse interval
    FFT -> real-part intervals, vectorised.

    centers, radii: [..., N] (the input intervals c +- r; leading dims an
    optional batch of independent interval vectors), cast to float32;
    multipliers: [N] complex per-frequency factors (e.g. 1/(K_hat + eps)),
    cast to complex64. Returns (out_centers [..., N], out_radii [..., N])
    of the real part, float32 tensors on `device` (default: that of
    `centers` when it is a tensor, else the card).

    Equal to real_interval(inverse_interval_fft([complex_prod(z, C) for z,
    C in zip(interval_fft(...), multipliers)])) at float32 rounding. The
    radius map is one matrix product, in full float32 (TF32 off).
    """
    from ..models.fno import precision_scope

    if device is None:
        device = centers.device if isinstance(centers, torch.Tensor) else "cuda"
    c = torch.as_tensor(centers).to(device=device, dtype=torch.float32)
    r = torch.as_tensor(radii).to(device=device, dtype=torch.float32)
    C = torch.as_tensor(multipliers).to(device=device, dtype=torch.complex64)
    N = c.shape[-1]
    out_centers = torch.real(torch.fft.ifft(torch.fft.fft(c, dim=-1) * C, dim=-1))

    # the radius kernel depends only on the circular lag k - j, so the map
    # is an O(N^2) circular correlation, never an [N, N, N] twiddle tensor
    w = _lag_kernel(C)
    h = torch.arange(N, device=c.device)
    lag = (h[:, None] - h[None, :]) % N                                # [k, j]
    with precision_scope("highest"):
        out_radii = r @ w[lag].T / N
    return out_centers, out_radii
