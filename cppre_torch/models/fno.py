"""Multivariate Fourier Neural Operator (FNO2d) as torch `nn.Module`s.

Port of `cppre.models.fno` (2-D half). Parameter names follow the reference
`Base_FNO.FNO_multi2d` state_dict, which `cppre.utils.torch_compat` maps:

    fc0_time, fc1_time, fc2_time                Linear (weight [out, in])
    f{i}.conv.weights{1,2}                      cfloat [in, out, V, m1, m2]
    f{i}.mlp.mlp{1,2}, f{i}.w, f{i}.b           1x1 channel maps
                                                (weight [out, in, 1, 1, 1])

so a reference checkpoint loads with `load_state_dict`, and
`cppre.utils.fno_params_from_torch(model.state_dict(), template)` carries
the port's weights into the JAX package.

Spectral convolution: ``spectral_impl='dft'`` computes exactly the kept
modes as truncated DFTs against float64-built tables (the JAX package's
default path); ``'fft'`` uses `torch.fft`. Configurations the DFT path
cannot express (2*m1 > Nx, or m2 > Ny//2+1) take the FFT path, as in
`cppre`. Channel maps are matrix products over the channel axis, never
convolutions, so cuDNN's TF32 default cannot reach them; on a GPU keep
`torch.backends.cuda.matmul.allow_tf32` False for full float32.

Random init draws from an explicit `torch.Generator` on the CPU, then
moves to `device`, so a seed gives the same weights on every device. The
device defaults to the card (`"cuda"`); CPU callers pass `device="cpu"`.

I/O contract: [BS, Nvar, Nx, Ny, T_in] -> [BS, Nvar, Nx, Ny, step].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SpectralConv2d", "FNO2d", "FNO_multi2d", "count_params", "get_grid"]


def _uniform_(t, bound, generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class _Linear(nn.Module):
    """y = x @ weight.T + bias over the last axis (`nn.Linear`'s layout and
    default init, drawn from `generator`)."""

    def __init__(self, in_features, out_features, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        bound = 1.0 / math.sqrt(in_features)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class _Channel1x1(nn.Module):
    """1x1x1 channel map on [B, C, V, Nx, Ny] with a Conv3d-shaped weight
    [out, in, 1, 1, 1], applied as a matrix product over the channel axis."""

    def __init__(self, in_channels, out_channels, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return torch.movedim(F.linear(torch.movedim(x, 1, -1), w, self.bias), -1, 1)


class _ChannelMLP(nn.Module):
    """mlp2(gelu(mlp1(x))) over the channel axis (reference MLP)."""

    def __init__(self, in_channels, out_channels, mid_channels, generator=None):
        super().__init__()
        self.mlp1 = _Channel1x1(in_channels, mid_channels, generator)
        self.mlp2 = _Channel1x1(mid_channels, out_channels, generator)

    def forward(self, x):
        return self.mlp2(F.gelu(self.mlp1(x)))


def _dft_basis(n, freqs, device):
    """cos/sin tables F[x, k] of e^{-2 pi i k x / n}, built in float64."""
    ang = -2.0 * np.pi * np.outer(np.arange(n), np.asarray(freqs)) / n
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def _irfft_weights(n, m, device):
    """Hermitian-expansion weights of a one-sided spectrum of length m: 1 for
    k = 0 (and the Nyquist bin if included), else 2."""
    w = np.full(m, 2.0)
    w[0] = 1.0
    if n % 2 == 0 and m == n // 2 + 1:
        w[-1] = 1.0
    return torch.tensor(w, dtype=torch.float32, device=device)


def _cmul(xr, xi, wr, wi, eq):
    """Complex einsum as 4 real einsums (returns re, im)."""
    re = torch.einsum(eq, xr, wr) - torch.einsum(eq, xi, wi)
    im = torch.einsum(eq, xr, wi) + torch.einsum(eq, xi, wr)
    return re, im


class SpectralConv2d(nn.Module):
    """2-D Fourier layer: rFFT2 -> per-mode channel mixing -> irFFT2.

    Two complex weights [in, out, V, m1, m2] act on the low-kx and high-kx
    corners of the one-sided spectrum; init is U[0, 1/in) on the real and
    imaginary parts.
    """

    def __init__(self, in_channels, out_channels, num_vars, modes1, modes2,
                 spectral_impl="dft", generator=None):
        super().__init__()
        if spectral_impl not in ("dft", "fft"):
            raise ValueError(f"unknown spectral_impl {spectral_impl!r}")
        self.modes1, self.modes2 = modes1, modes2
        self.spectral_impl = spectral_impl
        shape = (in_channels, out_channels, num_vars, modes1, modes2)
        scale = 1.0 / in_channels
        self.weights1 = nn.Parameter(
            scale * torch.rand(shape, dtype=torch.cfloat, generator=generator))
        self.weights2 = nn.Parameter(
            scale * torch.rand(shape, dtype=torch.cfloat, generator=generator))

    def uses_dft(self, nx, ny) -> bool:
        """The DFT path sums overlapping low/high kx modes where the FFT path
        overwrites (2*m1 > Nx), and its Hermitian weights assume
        m2 <= Ny//2+1: such shapes take the FFT path."""
        return (self.spectral_impl == "dft" and 2 * self.modes1 <= nx
                and self.modes2 <= ny // 2 + 1)

    def forward(self, x):
        # x: [B, C_in, V, Nx, Ny] (real)
        nx, ny = x.shape[-2], x.shape[-1]
        m1, m2 = self.modes1, self.modes2
        w1r, w1i = self.weights1.real, self.weights1.imag
        w2r, w2i = self.weights2.real, self.weights2.imag
        eq = "bivxy,iovxy->bovxy"
        if self.uses_dft(nx, ny):
            freqs = list(range(m1)) + list(range(nx - m1, nx))
            cy, sy = _dft_basis(ny, range(m2), x.device)
            cx, sx = _dft_basis(nx, freqs, x.device)
            yr, yi = x @ cy, x @ sy                                     # [.., Nx, m2]
            xr = (torch.einsum("...xm,xk->...km", yr, cx)
                  - torch.einsum("...xm,xk->...km", yi, sx))
            xi = (torch.einsum("...xm,xk->...km", yr, sx)
                  + torch.einsum("...xm,xk->...km", yi, cx))
            lo_r, lo_i = _cmul(xr[..., :m1, :], xi[..., :m1, :], w1r, w1i, eq)
            hi_r, hi_i = _cmul(xr[..., m1:, :], xi[..., m1:, :], w2r, w2i, eq)
            zr = torch.cat([lo_r, hi_r], dim=-2)
            zi = torch.cat([lo_i, hi_i], dim=-2)
            vr = (torch.einsum("...km,xk->...xm", zr, cx)
                  + torch.einsum("...km,xk->...xm", zi, sx))
            vi = (torch.einsum("...km,xk->...xm", zi, cx)
                  - torch.einsum("...km,xk->...xm", zr, sx))
            w = _irfft_weights(ny, m2, x.device)
            return ((vr * w) @ cy.T + (vi * w) @ sy.T) / (nx * ny)

        x_ft = torch.fft.rfft2(x.float(), dim=(-2, -1))
        xr, xi = x_ft.real, x_ft.imag
        lo_r, lo_i = _cmul(xr[..., :m1, :m2], xi[..., :m1, :m2], w1r, w1i, eq)
        hi_r, hi_i = _cmul(xr[..., -m1:, :m2], xi[..., -m1:, :m2], w2r, w2i, eq)
        out_shape = (x.shape[0], w1r.shape[1], x.shape[2], nx, ny // 2 + 1)
        out_r = x.new_zeros(out_shape)
        out_i = x.new_zeros(out_shape)
        out_r[..., :m1, :m2] = lo_r
        out_r[..., nx - m1:, :m2] = hi_r
        out_i[..., :m1, :m2] = lo_i
        out_i[..., nx - m1:, :m2] = hi_i
        return torch.fft.irfft2(torch.complex(out_r, out_i), s=(nx, ny), dim=(-2, -1))


class _FNOBlock2d(nn.Module):
    """One Fourier block: gelu(mlp(spectral(x)) + w(x) + b(grid))."""

    def __init__(self, modes1, modes2, num_vars, width, spectral_impl="dft", generator=None):
        super().__init__()
        self.conv = SpectralConv2d(width, width, num_vars, modes1, modes2, spectral_impl,
                                   generator)
        self.mlp = _ChannelMLP(width, width, width, generator)
        self.w = _Channel1x1(width, width, generator)
        self.b = _Channel1x1(2, width, generator)

    def forward(self, x, grid):
        x1 = self.mlp(self.conv(x))
        return F.gelu(x1 + self.w(x) + self.b(grid))


def _linspace01(n, device):
    """`jnp.linspace(0, 1, n, dtype=float32)` bit for bit: i * f32(1/(n-1)),
    with the last point exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    g = torch.arange(n, dtype=torch.float32, device=device) * float(np.float32(1.0 / (n - 1)))
    g[-1] = 1.0
    return g


def get_grid(shape, device=None):
    """Coordinate features [BS, Nvar, Nx, Ny, 2] on [0, 1]^2 for a
    [BS, Nvar, Nx, Ny, ...] input."""
    bs, nv, nx, ny = shape[0], shape[1], shape[2], shape[3]
    gx = _linspace01(nx, device).reshape(1, 1, nx, 1, 1).expand(bs, nv, nx, ny, 1)
    gy = _linspace01(ny, device).reshape(1, 1, 1, ny, 1).expand(bs, nv, nx, ny, 1)
    return torch.cat((gx, gy), dim=-1)


class FNO2d(nn.Module):
    """`FNO_multi2d(T_in, step, modes1, modes2, num_vars, width_time)`: lift
    Linear(T_in+2 -> width), 6 Fourier blocks with skip-adds every 3,
    project Linear(width -> 256 -> step).

    [BS, Nvar, Nx, Ny, T_in] -> [BS, Nvar, Nx, Ny, step].
    """

    def __init__(self, T_in, step, modes1, modes2, num_vars, width_time, width_vars=0,
                 spectral_impl="dft", *, device="cuda", generator=None):
        super().__init__()
        self.T_in, self.step = T_in, step
        self.modes1, self.modes2 = modes1, modes2
        self.num_vars, self.width_time, self.width_vars = num_vars, width_time, width_vars
        self.spectral_impl = spectral_impl
        g = generator
        self.fc0_time = _Linear(T_in + 2, width_time, g)
        for i in range(6):
            self.add_module(f"f{i}", _FNOBlock2d(modes1, modes2, num_vars, width_time,
                                                 spectral_impl, g))
        self.fc1_time = _Linear(width_time, 256, g)
        self.fc2_time = _Linear(256, step, g)
        self.to(device)

    def blocks(self):
        return [getattr(self, f"f{i}") for i in range(6)]

    def get_grid(self, shape, device=None):
        return get_grid(shape, device)

    def forward(self, x):
        grid = get_grid(x.shape, x.device).to(x.dtype)
        x = self.fc0_time(torch.cat((x, grid), dim=-1))
        x = x.permute(0, 4, 1, 2, 3)                       # [B, W, V, Nx, Ny]
        # the grid is the same for every sample: the bias branch b(grid)
        # runs at batch 1 and broadcasts
        grid_c = grid[:1].permute(0, 4, 1, 2, 3)
        f = self.blocks()
        x0 = f[0](x, grid_c)
        x = f[1](x0, grid_c)
        x = f[2](x, grid_c) + x0
        x1 = f[3](x, grid_c)
        x = f[4](x1, grid_c)
        x = f[5](x, grid_c) + x1
        x = x.permute(0, 2, 3, 4, 1)                       # [B, V, Nx, Ny, W]
        return self.fc2_time(F.gelu(self.fc1_time(x)))


FNO_multi2d = FNO2d


def count_params(model) -> int:
    """Total parameter count; a complex parameter counts its real and
    imaginary parts (reference `count_params`)."""
    return sum(p.numel() * (2 if p.is_complex() else 1) for p in model.parameters())
