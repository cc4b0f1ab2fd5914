"""Multivariate Fourier Neural Operators (FNO2d, FNO1d) as torch `nn.Module`s.

Port of `cppre.models.fno`. Parameter names follow the reference
`Base_FNO.FNO_multi2d` / `FNO_multi1d` state_dicts, which
`cppre.utils.torch_compat` maps:

    fc0_time, fc1_time, fc2_time                Linear (weight [out, in])
    f{i}.conv.weights{1,2}                      cfloat [in, out, V, m1, m2]
                                                (1-D: weights1 [in, out, V, m1])
    f{i}.mlp.mlp{1,2}, f{i}.w, f{i}.b           1x1 channel maps
                                                (weight [out, in, 1, 1, 1];
                                                1-D: [out, in, 1, 1])

so a reference checkpoint loads with `load_state_dict`, and
`cppre.utils.fno_params_from_torch(model.state_dict(), template)` carries
the port's weights into the JAX package.

Spectral convolution: ``spectral_impl='dft'`` computes exactly the kept
modes as truncated DFTs against float64-built tables (the JAX package's
default path); ``'fft'`` uses `torch.fft`. Configurations the DFT path
cannot express (2*m1 > Nx, or m2 > Ny//2+1; 1-D: m1 > Nx//2+1) take the FFT
path, as in `cppre`. Channel maps are matrix products over the channel axis, never
convolutions, so cuDNN's TF32 default cannot reach them; on a GPU keep
`torch.backends.cuda.matmul.allow_tf32` False for full float32.

Random init draws from an explicit `torch.Generator` on the CPU, then
moves to `device`, so a seed gives the same weights on every device. The
device defaults to the card (`"cuda"`); CPU callers pass `device="cpu"`.

I/O contract: FNO2d [BS, Nvar, Nx, Ny, T_in] -> [BS, Nvar, Nx, Ny, step];
FNO1d [BS, Nvar, Nx, T_in] -> [BS, Nvar, Nx, step].
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SpectralConv1d", "SpectralConv2d", "FNO1d", "FNO2d", "FNO_multi1d", "FNO_multi2d",
           "count_params", "dropout", "get_grid", "precision_scope", "with_matmul_precision",
           "activation_dtype_scope", "with_activation_dtype", "train_scope", "with_train_precision"]


# ---------------------------------------------------------------------------
# Training precision. The CP phase needs full float32: TF32 or bf16 products
# make a forward depend on the batch shape, which breaks the exchangeability
# of calibration and prediction rollouts, and the physics residual is a
# near-cancellation that bf16 fields cannot resolve. Training does not: SGD
# noise dwarfs the rounding. So only training applies are wrapped.
#
# JAX fixes a precision when it traces, for the forward and its VJP alike.
# Torch runs the backward, and the checkpoint recompute inside it, after the
# wrapped call has returned, so a wrapper that scoped only its own call
# would train the backward at full precision. The wrappers therefore carry
# their scope (`.scope`), and a train step enters `train_scope(apply_fn)`
# around the forward and `loss.backward()` (`train.loops.make_train_step`).
# ---------------------------------------------------------------------------

# cppre's precision names -> torch's float32 matmul precision
_MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


@contextlib.contextmanager
def precision_scope(precision: str):
    """Run float32 matrix products at `precision` inside the block:
    "highest" (full float32), "high" (TF32 on the card) or "default"
    (torch's "medium": TF32 on the card, bf16 products where the CPU has
    them). cuDNN's TF32 follows: off at "highest", on otherwise. The
    previous matmul precision and `torch.backends.cudnn.allow_tf32` come
    back on exit, also on an exception."""
    if precision not in _MATMUL_PRECISION:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{sorted(_MATMUL_PRECISION)}")
    old = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[precision])
    torch.backends.cudnn.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cudnn.allow_tf32 = old[1]


def with_matmul_precision(apply_fn, precision: str):
    """`apply_fn` run under `precision_scope(precision)`, tagged with that
    scope (`.scope`) for the train step's backward. Wrap only training
    applies: the calibration and prediction rollouts stay at "highest"."""
    if precision not in _MATMUL_PRECISION:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{sorted(_MATMUL_PRECISION)}")

    def wrapped(*args, **kwargs):
        with precision_scope(precision):
            return apply_fn(*args, **kwargs)

    wrapped.scope = functools.partial(precision_scope, precision)
    return wrapped


@contextlib.contextmanager
def activation_dtype_scope(dtype):
    """Autocast to `dtype` inside the block (None: native float32), on the
    CPU and, where there is one, the card: matrix products, einsums and
    linear layers take `dtype` inputs and give `dtype` outputs; parameters
    stay float32."""
    with contextlib.ExitStack() as stack:
        if dtype is not None:
            stack.enter_context(torch.autocast("cpu", dtype=dtype))
            if torch.cuda.is_available():
                stack.enter_context(torch.autocast("cuda", dtype=dtype))
        yield


def with_activation_dtype(apply_fn, dtype=torch.bfloat16):
    """Mixed-precision TRAINING apply: `dtype` activations over float32
    master weights. The forward (and its checkpoint recompute) runs under
    `activation_dtype_scope(dtype)`, so the DFT-as-matmul spectral path and
    the channel maps contract in `dtype`; the output comes back as float32.
    bf16 shares float32's exponent range, so no loss scaling is needed.
    Tagged with its scope (`.scope`) for the train step's backward. The
    kernels K4-K7 take float32 only: wrap a plain apply."""

    def wrapped(*args, **kwargs):
        with activation_dtype_scope(dtype):
            out = apply_fn(*args, **kwargs)
        return out.float() if out.dtype == dtype else out

    wrapped.scope = functools.partial(activation_dtype_scope, dtype)
    return wrapped


def with_train_precision(apply_fn, train_precision: str):
    """A training apply at `train_precision`, cppre's keyword: "highest"
    gives `apply_fn` itself, "bf16" `with_activation_dtype(apply_fn)`, and
    "high" or "default" `with_matmul_precision(apply_fn, ...)`."""
    if train_precision == "highest":
        return apply_fn
    if train_precision == "bf16":
        return with_activation_dtype(apply_fn)
    return with_matmul_precision(apply_fn, train_precision)


def train_scope(apply_fn):
    """The scope a train step enters around the forward and the backward
    of `apply_fn`: the one `with_matmul_precision` or
    `with_activation_dtype` tagged it with, else none."""
    return getattr(apply_fn, "scope", contextlib.nullcontext)()


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
    """1x1 channel map on [B, C, *rest] with a ConvNd-shaped weight
    [out, in, 1, ...] (one 1 per axis after the channels: three for the
    2-D FNO's [B, C, V, Nx, Ny], two for the 1-D's [B, C, V, Nx]), applied
    as a matrix product over the channel axis."""

    def __init__(self, in_channels, out_channels, generator=None, ones=3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels) + (1,) * ones))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return torch.movedim(F.linear(torch.movedim(x, 1, -1), w, self.bias), -1, 1)


class _ChannelMLP(nn.Module):
    """mlp2(gelu(mlp1(x))) over the channel axis (reference MLP)."""

    def __init__(self, in_channels, out_channels, mid_channels, generator=None, ones=3):
        super().__init__()
        self.mlp1 = _Channel1x1(in_channels, mid_channels, generator, ones)
        self.mlp2 = _Channel1x1(mid_channels, out_channels, generator, ones)

    def forward(self, x):
        return self.mlp2(F.gelu(self.mlp1(x)))


def _dft_basis(n, freqs, device):
    """cos/sin tables F[x, k] of e^{-2 pi i k x / n}, built in float64 and
    kept per (n, freqs, device), so a forward copies no table to the card."""
    return _dft_tables(n, tuple(freqs), torch.device(device))


@functools.lru_cache(maxsize=64)
def _dft_tables(n, freqs, device):
    ang = -2.0 * np.pi * np.outer(np.arange(n), np.asarray(freqs)) / n
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=64)
def _irfft_weights(n, m, device):
    """Hermitian-expansion weights of a one-sided spectrum of length m: 1 for
    k = 0 (and the Nyquist bin if included), else 2; kept like the tables."""
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


def dropout(x, rate: float, deterministic: bool = True, generator=None):
    """flax's `nn.Dropout`: with `deterministic` False, keep each value with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate), the
    mask drawn from `generator` (a `torch.Generator` on x's device, which
    a live dropout requires); else x unchanged."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("a live dropout draws its mask from an explicit torch.Generator: "
                         "pass generator=")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _FNOBlock2d(nn.Module):
    """One Fourier block: gelu(mlp(spectral(x)) + w(x) + b(grid)). With
    dropout_rate > 0, dropout follows the spectral-mlp branch."""

    def __init__(self, modes1, modes2, num_vars, width, spectral_impl="dft", generator=None,
                 dropout_rate=0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv = SpectralConv2d(width, width, num_vars, modes1, modes2, spectral_impl,
                                   generator)
        self.mlp = _ChannelMLP(width, width, width, generator)
        self.w = _Channel1x1(width, width, generator)
        self.b = _Channel1x1(2, width, generator)

    def forward(self, x, grid, deterministic: bool = True, generator=None):
        x1 = dropout(self.mlp(self.conv(x)), self.dropout_rate, deterministic, generator)
        return F.gelu(x1 + self.w(x) + self.b(grid))


def _linspace01(n, device):
    """`jnp.linspace(0, 1, n, dtype=float32)` bit for bit: i * f32(1/(n-1)),
    with the last point exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    # built on the device with no copy from the host, so a CUDA graph can
    # capture it
    g = torch.arange(n - 1, dtype=torch.float32, device=device) * float(np.float32(1.0 / (n - 1)))
    return torch.cat([g, torch.ones(1, dtype=torch.float32, device=device)])


def get_grid(shape, device=None):
    """Coordinate features [BS, Nvar, Nx, Ny, 2] on [0, 1]^2 for a
    [BS, Nvar, Nx, Ny, ...] input."""
    bs, nv, nx, ny = shape[0], shape[1], shape[2], shape[3]
    gx = _linspace01(nx, device).reshape(1, 1, nx, 1, 1).expand(bs, nv, nx, ny, 1)
    gy = _linspace01(ny, device).reshape(1, 1, 1, ny, 1).expand(bs, nv, nx, ny, 1)
    return torch.cat((gx, gy), dim=-1)


HEAD_HIDDEN = 256   # the projection's hidden width


class FNO2d(nn.Module):
    """`FNO_multi2d(T_in, step, modes1, modes2, num_vars, width_time)`: lift
    Linear(T_in+2 -> width), 6 Fourier blocks with skip-adds every 3,
    project Linear(width -> 256 -> step).

    With `dropout_rate` > 0 it is `FNO_multi2d_Dropout`: dropout after the
    lift, after each block's spectral-mlp branch and between the head's two
    layers. As in `cppre`, the forward is deterministic unless called with
    `deterministic=False`, and then the masks come from `generator`.

    [BS, Nvar, Nx, Ny, T_in] -> [BS, Nvar, Nx, Ny, step].
    """

    def __init__(self, T_in, step, modes1, modes2, num_vars, width_time, width_vars=0,
                 dropout_rate=0.0, spectral_impl="dft", *, device="cuda", generator=None):
        super().__init__()
        self.T_in, self.step = T_in, step
        self.modes1, self.modes2 = modes1, modes2
        self.num_vars, self.width_time, self.width_vars = num_vars, width_time, width_vars
        self.dropout_rate = dropout_rate
        self.spectral_impl = spectral_impl
        g = generator
        self.fc0_time = _Linear(T_in + 2, width_time, g)
        for i in range(6):
            self.add_module(f"f{i}", _FNOBlock2d(modes1, modes2, num_vars, width_time,
                                                 spectral_impl, g, dropout_rate))
        self._make_head(width_time, step, g)
        self.to(device)

    def _make_head(self, width_time, step, g):
        self.fc1_time = _Linear(width_time, HEAD_HIDDEN, g)
        self.fc2_time = _Linear(HEAD_HIDDEN, step, g)

    def head_layers(self):
        """The projection's two layers (objects with .weight and .bias), as
        the fused applies take them."""
        return self.fc1_time, self.fc2_time

    def head_width(self) -> int:
        """The projection's hidden width, as its first layer holds it."""
        return self.fc1_time.weight.shape[0]

    def blocks(self):
        return [getattr(self, f"f{i}") for i in range(6)]

    def get_grid(self, shape, device=None):
        return get_grid(shape, device)

    def body(self, x, deterministic: bool = True, generator=None):
        """Lift and the six blocks: [B, V, Nx, Ny, T_in] -> [B, V, Nx, Ny, W]."""
        drop = lambda z: dropout(z, self.dropout_rate, deterministic, generator)
        grid = get_grid(x.shape, x.device).to(x.dtype)
        x = drop(self.fc0_time(torch.cat((x, grid), dim=-1)))
        x = x.permute(0, 4, 1, 2, 3)                       # [B, W, V, Nx, Ny]
        # the grid is the same for every sample: the bias branch b(grid)
        # runs at batch 1 and broadcasts
        grid_c = grid[:1].permute(0, 4, 1, 2, 3)
        f = [lambda z, b=b: b(z, grid_c, deterministic, generator) for b in self.blocks()]
        x0 = f[0](x)
        x = f[1](x0)
        x = f[2](x) + x0
        x1 = f[3](x)
        x = f[4](x1)
        x = f[5](x) + x1
        return x.permute(0, 2, 3, 4, 1)                    # [B, V, Nx, Ny, W]

    def forward(self, x, deterministic: bool = True, generator=None):
        z = self.body(x, deterministic, generator)
        z = dropout(F.gelu(self.fc1_time(z)), self.dropout_rate, deterministic, generator)
        return self.fc2_time(z)


FNO_multi2d = FNO2d


class SpectralConv1d(nn.Module):
    """1-D Fourier layer: one complex weight [in, out, V, m1] on the low
    modes of the one-sided spectrum; init U[0, 1/in) on the real and
    imaginary parts. The DFT path (``spectral_impl='dft'`` and
    m1 <= Nx//2+1) computes exactly the kept modes against the 2-D layer's
    float64-built tables; otherwise `torch.fft.rfft`."""

    def __init__(self, in_channels, out_channels, num_vars, modes1, spectral_impl="dft",
                 generator=None):
        super().__init__()
        if spectral_impl not in ("dft", "fft"):
            raise ValueError(f"unknown spectral_impl {spectral_impl!r}")
        self.modes1, self.spectral_impl = modes1, spectral_impl
        shape = (in_channels, out_channels, num_vars, modes1)
        self.weights1 = nn.Parameter(
            (1.0 / in_channels) * torch.rand(shape, dtype=torch.cfloat, generator=generator))

    def uses_dft(self, nx) -> bool:
        return self.spectral_impl == "dft" and self.modes1 <= nx // 2 + 1

    def forward(self, x):
        # x: [B, C_in, V, Nx] (real)
        nx, m1 = x.shape[-1], self.modes1
        wr, wi = self.weights1.real, self.weights1.imag
        eq = "bivx,iovx->bovx"
        if self.uses_dft(nx):
            cx, sx = _dft_basis(nx, range(m1), x.device)
            lo_r, lo_i = _cmul(x @ cx, x @ sx, wr, wi, eq)
            w = _irfft_weights(nx, m1, x.device)
            return ((lo_r * w) @ cx.T + (lo_i * w) @ sx.T) / nx

        x_ft = torch.fft.rfft(x.float(), dim=-1)
        lo_r, lo_i = _cmul(x_ft.real[..., :m1], x_ft.imag[..., :m1], wr, wi, eq)
        out_shape = (x.shape[0], wr.shape[1], x.shape[2], nx // 2 + 1)
        out_r = x.new_zeros(out_shape)
        out_i = x.new_zeros(out_shape)
        out_r[..., :m1] = lo_r
        out_i[..., :m1] = lo_i
        return torch.fft.irfft(torch.complex(out_r, out_i), n=nx, dim=-1)


class _FNOBlock1d(nn.Module):
    """One 1-D Fourier block: gelu(mlp(spectral(x)) + w(x) + b(grid))."""

    def __init__(self, modes1, num_vars, width, spectral_impl="dft", generator=None):
        super().__init__()
        self.conv = SpectralConv1d(width, width, num_vars, modes1, spectral_impl, generator)
        self.mlp = _ChannelMLP(width, width, width, generator, ones=2)
        self.w = _Channel1x1(width, width, generator, ones=2)
        self.b = _Channel1x1(1, width, generator, ones=2)

    def forward(self, x, grid):
        x1 = self.mlp(self.conv(x))
        return F.gelu(x1 + self.w(x) + self.b(grid))


class FNO1d(nn.Module):
    """`FNO_multi1d(T_in, step, modes, num_vars, width)`: lift
    Linear(T_in+1 -> width), 6 Fourier blocks with skip-adds every 3,
    project Linear(width -> 256 -> step).

    [BS, Nvar, Nx, T_in] -> [BS, Nvar, Nx, step]. Random init draws from
    `generator` on the CPU, then moves to `device` (the card by default).
    """

    def __init__(self, T_in, step, modes1, num_vars, width_time, width_vars=0,
                 spectral_impl="dft", *, device="cuda", generator=None):
        super().__init__()
        self.T_in, self.step, self.modes1 = T_in, step, modes1
        self.num_vars, self.width_time, self.width_vars = num_vars, width_time, width_vars
        self.spectral_impl = spectral_impl
        g = generator
        self.fc0_time = _Linear(T_in + 1, width_time, g)
        for i in range(6):
            self.add_module(f"f{i}", _FNOBlock1d(modes1, num_vars, width_time, spectral_impl, g))
        self.fc1_time = _Linear(width_time, 256, g)
        self.fc2_time = _Linear(256, step, g)
        self.to(device)

    def blocks(self):
        return [getattr(self, f"f{i}") for i in range(6)]

    def get_grid(self, shape, device=None):
        """Coordinate feature [BS, Nvar, Nx, 1] on [0, 1]."""
        bs, nv, nx = shape[0], shape[1], shape[2]
        return _linspace01(nx, device).reshape(1, 1, nx, 1).expand(bs, nv, nx, 1)

    def forward(self, x):
        grid = self.get_grid(x.shape, x.device).to(x.dtype)
        x = self.fc0_time(torch.cat((x, grid), dim=-1))
        x = x.permute(0, 3, 1, 2)                          # [B, W, V, Nx]
        # the bias branch b(grid) runs at batch 1 and broadcasts
        grid_c = grid[:1].permute(0, 3, 1, 2)
        f = self.blocks()
        x0 = f[0](x, grid_c)
        x = f[1](x0, grid_c)
        x = f[2](x, grid_c) + x0
        x1 = f[3](x, grid_c)
        x = f[4](x1, grid_c)
        x = f[5](x, grid_c) + x1
        x = x.permute(0, 2, 3, 1)                          # [B, V, Nx, W]
        return self.fc2_time(F.gelu(self.fc1_time(x)))


FNO_multi1d = FNO1d


def count_params(model) -> int:
    """Total parameter count; a complex parameter counts its real and
    imaginary parts (reference `count_params`)."""
    return sum(p.numel() * (2 if p.is_complex() else 1) for p in model.parameters())
