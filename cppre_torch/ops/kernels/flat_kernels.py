"""Flat-layout joint-CP scores: kernels K10, K11 and K12.

Port of `cppre/ops/pallas/flat_kernels.py`, with its public names and
signatures. The two spatial axes are merged into one, L = Nx * Ny (a view),
and the residual is evaluated over the flat window j in [0, Lo),
Lo = L - 2 off, of the x-interior: off = Ny, or Ny + 1 for a 3x3x3 wave
kernel with a corner tap (`_composite_off`). Flat output j is the cell at
(x, y) = divmod(off + j, Ny); its y-wrap columns (y = 0 or Ny - 1) read into
the neighbouring rows and are masked out of the scores only.

* K10 `_flat_paired_absdiff_stats`: truth, prediction [BS, nvar, Nt, L] ->
  |d| [BS, Nt-2, Lo], sum and sumsq of d over the batch [Nt-2, Lo],
  d = PRE(truth) - PRE(pred).
* K11 `_flat_residual_kernel`: fields [BS, nvar, Nt, L] -> PRE [BS, Nt-2, Lo].
* K12 `_flat_absdiff_stats_from_res`: prediction and K11's residual of the
  truth -> K10's outputs.

One CUDA source (`csrc/flat_kernels.cu`) holds the three; they call the
cells of `csrc/stencil_cells.cuh` (K1's), so K11 then K12 gives K10's bits.
The plain versions evaluate the same math as shifted slices of the flat
layout (`_flat_ops`), as cppre's `_ns_momentum_flat`, `_mhd_flat` and
`_composite_flat` do.

`_scores_flat` picks K10, or K11 then K12, by `flat_routing_decision`, a
pure function of the shape (cppre decides by its TPU VMEM estimates, which
have no counterpart here), then forms cppre's scores exactly: the one-pass
modulation sqrt(max(sumsq/n - mean^2, 0)) + eps and the masked sup-norm.
The flat contract emits |d|, not d, so the centred sum of squares that the
port's other score routes take cannot be formed from it. A wave kernel that
is not 3x3x3 goes to `wave_joint_cp_scores_fused`.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each kernel counts its launches on the function named
above (`launch_counts()` in `ops.kernels`).
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from . import _build
from .stencil_kernels import (
    _cell_args,
    _check_pair,
    _mhd_cell,
    _ns_cell,
    _Residual,
    _taps_cell,
    wave_joint_cp_scores_fused,
    wave_joint_cp_scores_plain,
)

__all__ = [
    "ns_joint_cp_scores_flat",
    "ns_joint_cp_scores_flat_plain",
    "mhd_joint_cp_scores_flat",
    "mhd_joint_cp_scores_flat_plain",
    "wave_joint_cp_scores_flat",
    "wave_joint_cp_scores_flat_plain",
    "flat_routing_decision",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _composite_off(kernel, ny: int) -> int:
    """Flat-window margin needed by a 3x3x3 kernel: ny for face taps,
    ny+1 when any corner tap (x and y offset together) is nonzero."""
    kernel = np.asarray(kernel)
    off = ny
    for it, ix, iy in itertools.product(range(3), range(3), range(3)):
        if kernel[it, ix, iy] != 0.0:
            off = max(off, abs((ix - 1) * ny + (iy - 1)))
    return off


def _flat_ops(nt: int, ny: int, lo: int, off: int):
    """The window and derivatives of the flat layout, for `_ns_momentum_math`
    and `_mhd_math`: a[..., nt, L] -> [..., nt-2, lo], the x-derivative a
    shift of +-ny, the y-derivative a shift of +-1."""
    W = lambda a, st, sf: a[..., 1 + st: nt - 1 + st, off + sf: off + sf + lo]
    I = lambda a: W(a, 0, 0)
    d_t = lambda a: W(a, 1, 0) - W(a, -1, 0)
    d_x = lambda a: W(a, 0, ny) - W(a, 0, -ny)
    d_y = lambda a: W(a, 0, 1) - W(a, 0, -1)
    d_lap = lambda a: (W(a, 0, ny) + W(a, 0, -ny) + W(a, 0, 1) + W(a, 0, -1) - 4.0 * I(a))
    return I, d_t, d_x, d_y, d_lap


def _composite_flat(kernel, a, nt: int, ny: int, lo: int, off: int):
    """A 3x3x3 tap table over the flat window of a [..., nt, L] field: the
    non-zero taps in `itertools.product` order, w * x summed in that order
    (float32 weights), as `stencil_shift_add` and the K8 tap table."""
    acc = None
    for it, ix, iy in itertools.product(range(3), range(3), range(3)):
        w = float(np.float32(kernel[it, ix, iy]))
        if w == 0.0:
            continue
        s_f = (ix - 1) * ny + (iy - 1)
        term = a[..., it: nt - 2 + it, off + s_f: off + s_f + lo] * w
        acc = term if acc is None else acc + term
    return acc


def _flat_math(fields, res: _Residual, ny: int, off: int):
    """The plain residual of cell `res` over the flat window:
    [BS, nvar, nt, L] -> [BS, nt-2, Lo]."""
    nt, L = fields.shape[2:]
    lo = L - 2 * off
    if res.kernel is not None:
        return _composite_flat(res.kernel, fields[:, 0], nt, ny, lo, off)
    return res.math(fields, ops=_flat_ops(nt, ny, lo, off))


def _check_flat(fields, res: _Residual, ny: int, off: int, what: str):
    if (fields.ndim != 4 or fields.shape[1] < res.nvar or fields.shape[2] < 3
            or res.k != 3 or fields.shape[3] % ny or not ny <= off <= ny + 1
            or fields.shape[3] - 2 * off <= 0):
        raise ValueError(f"{what}: expected [BS, nvar>={res.nvar}, Nt>=3, L=Nx*Ny] fields "
                         f"with Ny={ny}, a 3-wide cell and off in (Ny, Ny+1) leaving a "
                         f"window, got {tuple(fields.shape)}, k={res.k}, off={off}")


def _moments_plain(d):
    return d.abs(), torch.sum(d, dim=0), torch.sum(d * d, dim=0)


def _flat_paired_absdiff_stats_plain(truth, pred, res: _Residual, ny: int, off: int):
    """Plain PyTorch K10."""
    return _moments_plain(_flat_math(truth, res, ny, off) - _flat_math(pred, res, ny, off))


def _flat_residual_plain(fields, res: _Residual, ny: int, off: int):
    """Plain PyTorch K11."""
    return _flat_math(fields, res, ny, off)


def _flat_absdiff_stats_from_res_plain(pred, res_out, res: _Residual, ny: int, off: int):
    """Plain PyTorch K12."""
    return _moments_plain(res_out - _flat_math(pred, res, ny, off))


def _launch(which, a, b, out, s, sq, res: _Residual, ny: int, off: int, what: str):
    bs, nvar, nt, L = a.shape
    cell, tables = _cell_args(res, (L // ny, ny), a.device)
    lib = _build.library("flat_kernels")
    fn = _build.declare(lib, "cppre_flat_kernel",
                        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _P, _P, _I, _P])
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        rc = fn(which, cell[0], a.data_ptr(), ptr(b), out.data_ptr(), ptr(s), ptr(sq),
                bs, nvar, nt, L // ny, ny, off, *cell[1:], _build.stream_of(a))
    _build.check(lib, rc, what)


def _outputs(like, bs, nt, lo, moments=True):
    new = lambda *shape: torch.empty(shape, device=like.device, dtype=torch.float32)
    return (new(bs, nt - 2, lo),) + ((new(nt - 2, lo), new(nt - 2, lo)) if moments else ())


def _flat_paired_absdiff_stats(truth, pred, res: _Residual, ny: int, off: int):
    """Kernel K10: truth and prediction [BS, nvar, nt, L] -> (|d| [BS, nt-2,
    Lo], sum [nt-2, Lo], sumsq [nt-2, Lo]), the moments of d summed over the
    batch in sample order, every column of the window computed (y-wrap
    columns included)."""
    what = "flat_paired_absdiff_stats"
    _check_flat(truth, res, ny, off, what)
    if tuple(pred.shape) != tuple(truth.shape):
        raise ValueError(f"{what}: truth {tuple(truth.shape)} and prediction "
                         f"{tuple(pred.shape)} differ in shape")
    if not _build.on_cuda(truth):
        return _flat_paired_absdiff_stats_plain(truth, pred, res, ny, off)
    _build.require(truth, "truth")
    _build.require(pred, "prediction", truth.shape, device=truth.device)
    bs, _, nt, L = truth.shape
    out = _outputs(truth, bs, nt, L - 2 * off)
    _launch(10, truth, pred, *out, res, ny, off, what)
    _flat_paired_absdiff_stats.launches += 1
    return out


_flat_paired_absdiff_stats.launches = 0


def _flat_residual_kernel(fields, res: _Residual, ny: int, off: int):
    """Kernel K11: fields [BS, nvar, nt, L] -> the residual of cell `res` on
    the flat window [BS, nt-2, Lo]."""
    what = "flat_residual_kernel"
    _check_flat(fields, res, ny, off, what)
    if not _build.on_cuda(fields):
        return _flat_residual_plain(fields, res, ny, off)
    _build.require(fields, "fields")
    bs, _, nt, L = fields.shape
    (out,) = _outputs(fields, bs, nt, L - 2 * off, moments=False)
    _launch(11, fields, None, out, None, None, res, ny, off, what)
    _flat_residual_kernel.launches += 1
    return out


_flat_residual_kernel.launches = 0


def _flat_absdiff_stats_from_res(pred, res_out, res: _Residual, ny: int, off: int):
    """Kernel K12, the two-kernel route's second stage: the prediction
    [BS, nvar, nt, L] and the truth's residual [BS, nt-2, Lo] (K11) -> K10's
    outputs, reading each once."""
    what = "flat_absdiff_stats_from_res"
    _check_flat(pred, res, ny, off, what)
    bs, _, nt, L = pred.shape
    if tuple(res_out.shape) != (bs, nt - 2, L - 2 * off):
        raise ValueError(f"{what}: expected the truth's residual [{bs}, {nt - 2}, "
                         f"{L - 2 * off}], got {tuple(res_out.shape)}")
    if not _build.on_cuda(pred):
        return _flat_absdiff_stats_from_res_plain(pred, res_out, res, ny, off)
    _build.require(pred, "prediction")
    _build.require(res_out, "residual", device=pred.device)
    out = _outputs(pred, bs, nt, L - 2 * off)
    _launch(12, pred, res_out, *out, res, ny, off, what)
    _flat_absdiff_stats_from_res.launches += 1
    return out


_flat_absdiff_stats_from_res.launches = 0


# ---- routing + score assembly ---------------------------------------------------

def flat_routing_decision(shape) -> str:
    """Which route `_scores_flat` takes on the card for [BS, nvar, nt, nx, ny]
    inputs: 'paired' (K10) or 'two_kernel' (K11, then K12). A pure function
    of the shape. K10's threads each walk the whole batch, evaluating two
    cells per sample; K11 spreads the truth's cells over every (b, t, j),
    leaving K12 one cell per sample. Timed on an H100 (PERF.md), the two
    kernels won at BS x nvar = 1000 (wave, [1000, 20, 64, 64]: 2.2 vs 2.9 ms)
    and 600 (MHD, [100, 6, 20, 128, 128]: 3.5 vs 3.8 ms over the five
    equations, 0.94 vs 1.19 ms for induction) and lost at 300 (NS,
    [100, 3, 21, 100, 100]: 0.52 vs 0.38-0.40 ms)."""
    bs, nvar = shape[:2]
    return "two_kernel" if bs * nvar >= _TWO_KERNEL_MIN_LOAD else "paired"


# the batch x variables from which K11 then K12 beat K10 (flat_routing_decision)
_TWO_KERNEL_MIN_LOAD = 500


def _flat_scores_from_stats(absdiff, s, sq, n: int, nx: int, ny: int, off: int, eps: float):
    """cppre's flat score epilogue: the one-pass modulation, then the sup
    norm over the window's interior cells (y-wrap columns masked)."""
    mean = s / n
    mod = torch.sqrt(torch.clamp(sq / n - mean ** 2, min=0.0)) + eps
    f_idx = torch.arange(absdiff.shape[-1], device=absdiff.device) + off
    x_idx, y_idx = f_idx // ny, f_idx % ny
    valid = (x_idx >= 1) & (x_idx < nx - 1) & (y_idx > 0) & (y_idx < ny - 1)
    ratio = torch.where(valid, absdiff / mod, torch.zeros((), device=absdiff.device))
    return torch.amax(ratio, dim=(1, 2))


def _scores_flat(truth, pred, res: _Residual, eps: float, off: int | None = None,
                 plain: bool = False):
    """Flatten (a view), route, and form the masked sup-norm scores [BS].
    truth/pred [BS, nvar, nt, nx, ny]; `off` the flat window's margin
    (default ny). `plain` takes the plain versions on any device."""
    bs, nvar, nt, nx, ny = truth.shape
    off = ny if off is None else off
    L = nx * ny
    tf = truth.reshape(bs, nvar, nt, L)
    pf = pred.reshape(bs, nvar, nt, L)
    if plain:
        absdiff, s, sq = _flat_paired_absdiff_stats_plain(tf, pf, res, ny, off)
    elif flat_routing_decision(tuple(truth.shape)) == "paired":
        absdiff, s, sq = _flat_paired_absdiff_stats(tf, pf, res, ny, off)
    else:
        res_out = _flat_residual_kernel(tf, res, ny, off)
        absdiff, s, sq = _flat_absdiff_stats_from_res(pf, res_out, res, ny, off)
    return _flat_scores_from_stats(absdiff, s, sq, bs, nx, ny, off, eps)


def _check_scores_args(truth, prediction, res, what):
    if truth.ndim != 5:
        raise ValueError(f"{what}: expected [BS, nvar, Nt, Nx, Ny], got {tuple(truth.shape)}")
    _check_pair(truth, prediction, res, what)


def _ns_flat(truth, prediction, dt, dx, dy, nu, eps, plain):
    res = _ns_cell(dt, dx, dy, nu)
    _check_scores_args(truth, prediction, res, "ns_joint_cp_scores_flat")
    return _scores_flat(truth, prediction, res, eps, plain=plain)


def _mhd_flat(truth, prediction, equation, eps, plain):
    res = _mhd_cell(equation)
    _check_scores_args(truth, prediction, res, "mhd_joint_cp_scores_flat")
    return _scores_flat(truth, prediction, res, eps, plain=plain)


def _wave_flat(truth, prediction, kernel, eps, plain):
    kernel = np.asarray(kernel)
    if kernel.shape != (3, 3, 3):
        score = wave_joint_cp_scores_plain if plain else wave_joint_cp_scores_fused
        return score(truth, prediction, kernel, eps=eps)
    res = _taps_cell(kernel)
    _check_scores_args(truth[:, None], prediction[:, None], res, "wave_joint_cp_scores_flat")
    return _scores_flat(truth[:, None], prediction[:, None], res, eps,
                        off=_composite_off(kernel, truth.shape[-1]), plain=plain)


def ns_joint_cp_scores_flat(truth, prediction, dt: float, dx: float, dy: float,
                            nu: float = 0.001, eps: float = 1e-6):
    """Joint-CP nonconformity scores [BS] over the NS momentum PRE, flat
    layout: truth and prediction [BS, nvar>=3, Nt, Nx, Ny], through K10 (or
    K11 then K12), the one-pass modulation and the masked sup-norm."""
    return _ns_flat(truth, prediction, dt, dx, dy, nu, eps, False)


def ns_joint_cp_scores_flat_plain(truth, prediction, dt: float, dx: float, dy: float,
                                  nu: float = 0.001, eps: float = 1e-6):
    """Plain PyTorch `ns_joint_cp_scores_flat`."""
    return _ns_flat(truth, prediction, dt, dx, dy, nu, eps, True)


def mhd_joint_cp_scores_flat(truth, prediction, equation: str = "induction",
                             eps: float = 1e-6):
    """Joint-CP scores [BS] over any of the five ideal-MHD residuals, flat
    layout: truth and prediction [BS, 6, Nt, Nx, Ny]."""
    return _mhd_flat(truth, prediction, equation, eps, False)


def mhd_joint_cp_scores_flat_plain(truth, prediction, equation: str = "induction",
                                   eps: float = 1e-6):
    """Plain PyTorch `mhd_joint_cp_scores_flat`."""
    return _mhd_flat(truth, prediction, equation, eps, True)


def wave_joint_cp_scores_flat(truth, prediction, kernel, eps: float = 1e-6):
    """Joint-CP scores [BS] over the wave composite-kernel PRE, flat layout:
    truth and prediction [BS, Nt, Nx, Ny] single-variable trajectories. A
    kernel that is not 3x3x3 goes to `wave_joint_cp_scores_fused` (K1 and
    its epilogue, whose modulation is the centred one)."""
    return _wave_flat(truth, prediction, kernel, eps, False)


def wave_joint_cp_scores_flat_plain(truth, prediction, kernel, eps: float = 1e-6):
    """Plain PyTorch `wave_joint_cp_scores_flat`."""
    return _wave_flat(truth, prediction, kernel, eps, True)
