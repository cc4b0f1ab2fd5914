"""Spatially split 2-D FFT and spectral convolution (port of
`cppre.parallel.spectral`).

A 2-D FFT factorises into two batched 1-D FFTs with a transpose between
them, and the transpose is the only communication:

    x [..., Nx (split over 'sp'), Ny]
      --local fft over y-->                  [..., nx, Ny] complex64
      --all_to_all (Ny -> Ny/S, gather Nx)-->  [..., Nx, Ny/S]
      --local fft over x-->                  spectrum split over the y axis

`ifft2_sharded` inverts it (local ifft over x, transpose back, local ifft
over y), so a forward -> pointwise -> inverse round trip costs two
`all_to_all_single` calls, the least a distributed 2-D FFT needs. Both
extents must divide the mesh axis. Everything is complex64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Mesh, Sharded, _blocks

__all__ = ["fft2_sharded", "ifft2_sharded", "spectral_circular_conv_sharded"]


def _check(shape, n_shards):
    if shape[-2] % n_shards or shape[-1] % n_shards:
        raise ValueError(f"Nx and Ny must divide the mesh axis ({tuple(shape[-2:])} vs "
                         f"{n_shards})")


def _all_to_all(send, mesh: Mesh, axis: str):
    """all_to_all over `axis` of send [S, ...]: part s goes to rank s, and
    part s of the result came from rank s."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(torch.view_as_real(recv), torch.view_as_real(send),
                           group=mesh.group(axis))
    return recv


def _y_to_x(f, mesh: Mesh, axis: str):
    """[..., nx, Ny] -> [..., Nx, Ny/S]: scatter y, gather x."""
    s = mesh.shape[axis]
    *lead, nx, ny = f.shape
    send = torch.movedim(f.reshape(*lead, nx, s, ny // s), -2, 0).contiguous()
    recv = _all_to_all(send, mesh, axis)                    # [S, ..., nx, Ny/S]
    return torch.movedim(recv, 0, -3).reshape(*lead, s * nx, ny // s)


def _x_to_y(f, mesh: Mesh, axis: str):
    """[..., Nx, ny] -> [..., Nx/S, Ny]: scatter x, gather y."""
    s = mesh.shape[axis]
    *lead, nx, ny = f.shape
    send = torch.movedim(f.reshape(*lead, s, nx // s, ny), -3, 0).contiguous()
    recv = _all_to_all(send, mesh, axis)                    # [S, ..., Nx/S, ny]
    return torch.movedim(recv, 0, -2).reshape(*lead, nx // s, s * ny)


def fft2_sharded(x, mesh: Mesh, axis: str = "sp") -> Sharded:
    """2-D FFT over the last two axes of `x`, axis -2 (Nx) split over mesh
    axis `axis` on input. Returns the complex64 spectrum split over axis -1
    (the transposed layout: give it to `ifft2_sharded`, or do the pointwise
    work in that layout and spare a third all_to_all)."""
    part = _blocks(x, mesh, (axis,), (-2,))
    n_shards = mesh.shape[axis]
    _check(part.shape, n_shards)
    f = torch.fft.fft(part.local.to(torch.complex64), dim=-1)    # [.., nx, Ny]
    f = _y_to_x(f, mesh, axis)                                   # [.., Nx, Ny/S]
    f = torch.fft.fft(f, dim=-2)
    return Sharded(f, mesh, (axis,), (-1,), (part.shape[-1],))


def ifft2_sharded(X, mesh: Mesh, axis: str = "sp") -> Sharded:
    """Inverse of `fft2_sharded`: takes the y-split spectrum, returns the
    x-split spatial field (complex64; take .real for real signals)."""
    part = _blocks(X, mesh, (axis,), (-1,))
    _check(part.shape, mesh.shape[axis])
    f = torch.fft.ifft(part.local.to(torch.complex64), dim=-2)   # [.., Nx, ny]
    f = _x_to_y(f, mesh, axis)                                   # [.., Nx/S, Ny]
    f = torch.fft.ifft(f, dim=-1)
    return Sharded(f, mesh, (axis,), (-2,), (part.shape[-2],))


def spectral_circular_conv_sharded(field, kernel, mesh: Mesh, axis: str = "sp",
                                   correlation: bool = True) -> Sharded:
    """Periodic (circular) spectral correlation of an x-split field with a
    small kernel, whole on every rank: sharded fft2 -> pointwise product
    with the kernel's spectrum (computed once, in numpy, and sliced to the
    local y chunk) -> sharded ifft2. Matches the single-device
    `ifft2(fft2(field) * conj(fft2(kernel_padded)))` up to FFT rounding;
    correlation=True conjugates the kernel spectrum (the ConvOps
    correlation convention). Returns the real part, split over axis -2."""
    kernel = np.asarray(kernel)
    part = _blocks(field, mesh, (axis,), (-2,))
    Nx, Ny = part.shape[-2], part.shape[-1]
    kx, ky = kernel.shape[-2], kernel.shape[-1]
    n_shards = mesh.shape[axis]
    # centred zero-pad + roll so the kernel origin sits at (0, 0): circular
    # correlation with SAME alignment (output[i] = sum_k k[c+d] f[i+d])
    pad = np.zeros((Nx, Ny), dtype=kernel.dtype)
    pad[:kx, :ky] = kernel
    pad = np.roll(pad, (-(kx // 2), -(ky // 2)), axis=(0, 1))
    k_fr = np.fft.fft2(pad)
    if correlation:
        k_fr = np.conj(k_fr)
    chunk = Ny // n_shards
    idx = mesh.index(axis)
    k_loc = torch.as_tensor(k_fr[:, idx * chunk:(idx + 1) * chunk].astype(np.complex64),
                            device=mesh.device)
    X = fft2_sharded(part, mesh, axis)
    out = ifft2_sharded(Sharded(X.local * k_loc, mesh, (axis,), (-1,), (Ny,)), mesh, axis)
    return Sharded(out.local.real, mesh, (axis,), (-2,), (Nx,))
