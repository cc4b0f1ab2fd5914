"""NS momentum PRE kernels: the residual (K2) and the joint-CP diff + moments (K1).

Port of the NS instances of `cppre/ops/pallas/stencil_kernels.py`. Each
kernel has a plain PyTorch version of the same math beside it:

* `ns_momentum_residual_fused` (CUDA `csrc/stencil_kernels.cu`) /
  `ns_momentum_residual_plain`: fields [BS, Nvar>=3, Nt, Nx, Ny] (u, v, p)
  -> interior residual [BS, Nt-2, Nx-2, Ny-2], equal to
  `PRE_NS.residual_momentum(fields)`.
* `ns_joint_cp_diff_stats` / `ns_joint_cp_diff_stats_plain`: truth and
  prediction read once; returns (diff [BS, *out], sum [*out], sumsq [*out])
  with diff = PRE(truth) - PRE(pred), optionally stored as bfloat16
  (`diff_dtype`); the moments always come from the float32 diff.
* `ns_joint_cp_scores_fused`: the joint-CP nonconformity scores, the diff +
  moments kernel followed by the `_scores_from_diff_stats` epilogue in
  plain torch (as in the JAX package, where it is jnp outside the kernel).

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each kernel wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = [
    "ns_momentum_residual_fused",
    "ns_momentum_residual_plain",
    "ns_joint_cp_diff_stats",
    "ns_joint_cp_diff_stats_plain",
    "ns_joint_cp_scores_fused",
    "ns_joint_cp_scores_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _interior(a):
    return a[..., 1:-1, 1:-1, 1:-1]


def _d_t(a):
    return a[..., 2:, 1:-1, 1:-1] - a[..., :-2, 1:-1, 1:-1]


def _d_x(a):
    return a[..., 1:-1, 2:, 1:-1] - a[..., 1:-1, :-2, 1:-1]


def _d_y(a):
    return a[..., 1:-1, 1:-1, 2:] - a[..., 1:-1, 1:-1, :-2]


def _d_lap(a):
    return (a[..., 1:-1, 2:, 1:-1] + a[..., 1:-1, :-2, 1:-1]
            + a[..., 1:-1, 1:-1, 2:] + a[..., 1:-1, 1:-1, :-2] - 4.0 * _interior(a))


def _coef(dt, dx, dy, nu):
    """The float32 constants of the residual, in the kernels' order."""
    f = lambda v: float(np.float32(v))
    return f(dx * dy), f(dt * dy), f(dt * dx), f(nu), f(dt)


def _ns_momentum_math(fields, dt, dx, dy, nu):
    """The momentum residual on the interior window of [..., Nvar, Nt, Nx, Ny]
    fields, every derivative a shifted slice, in the term order of
    `cppre.ops.pallas.stencil_kernels._ns_momentum_math`."""
    cxy, cty, ctx, nu, dt = _coef(dt, dx, dy, nu)
    u, v, p = fields[:, 0], fields[:, 1], fields[:, 2]
    ui, vi = _interior(u), _interior(v)
    res_x = (_d_t(u) * cxy + ui * _d_x(u) * cty + vi * _d_y(u) * ctx
             - nu * _d_lap(u) * dt + _d_x(p) * cty)
    res_y = (_d_t(v) * cxy + ui * _d_x(v) * ctx + vi * _d_y(v) * cty
             - nu * _d_lap(v) * dt + _d_y(p) * ctx)
    return res_x + res_y


def _check_fields(fields, what):
    if fields.ndim != 5 or fields.shape[1] < 3 or min(fields.shape[2:]) < 3:
        raise ValueError(f"{what}: expected [BS, Nvar>=3, Nt>=3, Nx>=3, Ny>=3] fields, "
                         f"got {tuple(fields.shape)}")


# ---- K2 ---------------------------------------------------------------------

def ns_momentum_residual_plain(fields, dt: float, dx: float, dy: float, nu: float = 0.001):
    """Plain PyTorch NS momentum residual: [BS, Nvar, Nt, Nx, Ny] -> [BS, Nt-2, Nx-2, Ny-2]."""
    _check_fields(fields, "ns_momentum_residual")
    return _ns_momentum_math(fields, dt, dx, dy, nu)


def ns_momentum_residual_fused(fields, dt: float, dx: float, dy: float, nu: float = 0.001):
    """Fused NS momentum PRE (kernel K2): fields [BS, Nvar>=3, Nt, Nx, Ny]
    (u, v, p) -> interior residual [BS, Nt-2, Nx-2, Ny-2], equal to
    `PRE_NS.residual_momentum(fields, boundary=False)`."""
    _check_fields(fields, "ns_momentum_residual_fused")
    if not _build.on_cuda(fields):
        return ns_momentum_residual_plain(fields, dt, dx, dy, nu)
    _build.require(fields, "fields")
    bs, nvar, nt, nx, ny = fields.shape
    out = torch.empty((bs, nt - 2, nx - 2, ny - 2), device=fields.device, dtype=torch.float32)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_ns_momentum_residual",
                        [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P])
    with torch.cuda.device(fields.device):
        rc = fn(fields.data_ptr(), out.data_ptr(), bs, nvar, nt, nx, ny,
                *_coef(dt, dx, dy, nu), _build.stream_of(fields))
    _build.check(lib, rc, "ns_momentum_residual_fused")
    ns_momentum_residual_fused.launches += 1
    return out


ns_momentum_residual_fused.launches = 0


# ---- K1 ---------------------------------------------------------------------

def ns_joint_cp_diff_stats_plain(truth, prediction, dt: float, dx: float, dy: float,
                                 nu: float = 0.001, diff_dtype=None):
    """Plain PyTorch (diff, sum, sumsq) of `ns_joint_cp_diff_stats`."""
    _check_fields(truth, "ns_joint_cp_diff_stats")
    diff = (_ns_momentum_math(truth, dt, dx, dy, nu)
            - _ns_momentum_math(prediction, dt, dx, dy, nu))
    s, sq = torch.sum(diff, dim=0), torch.sum(diff * diff, dim=0)
    return diff.to(diff_dtype or truth.dtype), s, sq


def ns_joint_cp_diff_stats(truth, prediction, dt: float, dx: float, dy: float,
                           nu: float = 0.001, samples_per_block: int = 1, diff_dtype=None):
    """One-pass joint-CP front end (kernel K1): reads truth and prediction
    [BS, Nvar>=3, Nt, Nx, Ny] once and returns (diff [BS, Nt-2, Nx-2, Ny-2],
    sum, sumsq [Nt-2, Nx-2, Ny-2]), diff = PRE(truth) - PRE(pred), the
    moments summed over the batch in sample order.

    `diff_dtype=torch.bfloat16` stores the diff in bfloat16 (halving its
    write and the score pass's read); the moments still accumulate from
    the float32 diff. `samples_per_block` is accepted for signature parity
    with `cppre`: every thread of the kernel walks the whole batch, so the
    result does not depend on it.
    """
    _check_fields(truth, "ns_joint_cp_diff_stats")
    if tuple(prediction.shape) != tuple(truth.shape):
        raise ValueError(f"truth {tuple(truth.shape)} and prediction "
                         f"{tuple(prediction.shape)} differ in shape")
    if samples_per_block < 1:
        raise ValueError(f"samples_per_block must be >= 1, got {samples_per_block}")
    diff_dtype = diff_dtype or torch.float32
    if diff_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"diff_dtype must be float32 or bfloat16, got {diff_dtype}")
    if not _build.on_cuda(truth):
        return ns_joint_cp_diff_stats_plain(truth, prediction, dt, dx, dy, nu, diff_dtype)
    _build.require(truth, "truth")
    _build.require(prediction, "prediction", truth.shape, device=truth.device)
    bs, nvar, nt, nx, ny = truth.shape
    out = (nt - 2, nx - 2, ny - 2)
    diff = torch.empty((bs,) + out, device=truth.device, dtype=diff_dtype)
    s = torch.empty(out, device=truth.device, dtype=torch.float32)
    sq = torch.empty(out, device=truth.device, dtype=torch.float32)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_ns_joint_cp_diff_stats",
                        [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _P])
    with torch.cuda.device(truth.device):
        rc = fn(truth.data_ptr(), prediction.data_ptr(), diff.data_ptr(),
                int(diff_dtype == torch.bfloat16), s.data_ptr(), sq.data_ptr(),
                bs, nvar, nt, nx, ny, *_coef(dt, dx, dy, nu), _build.stream_of(truth))
    _build.check(lib, rc, "ns_joint_cp_diff_stats")
    ns_joint_cp_diff_stats.launches += 1
    return diff, s, sq


ns_joint_cp_diff_stats.launches = 0


def _scores_from_diff_stats(diff, s, sq, n: int, eps: float):
    """Modulation std from the one-pass moments, then the per-sample
    sup-norm score (modulation_func + ncf_metric_joint). A bfloat16 diff is
    upcast first, so the score arithmetic is float32."""
    mean = s / n
    mod = torch.sqrt(torch.clamp(sq / n - mean * mean, min=0.0)) + eps
    r = diff.to(s.dtype).abs() / mod
    return torch.amax(r, dim=tuple(range(1, diff.ndim)))


def ns_joint_cp_scores_plain(truth, prediction, dt: float, dx: float, dy: float,
                             nu: float = 0.001, eps: float = 1e-6, diff_dtype=None):
    """Plain PyTorch `ns_joint_cp_scores_fused`."""
    diff, s, sq = ns_joint_cp_diff_stats_plain(truth, prediction, dt, dx, dy, nu, diff_dtype)
    return _scores_from_diff_stats(diff, s, sq, truth.shape[0], eps)


def ns_joint_cp_scores_fused(truth, prediction, dt: float, dx: float, dy: float,
                             nu: float = 0.001, eps: float = 1e-6,
                             samples_per_block: int = 1, diff_dtype=None):
    """Joint-CP nonconformity scores [BS] over the NS momentum PRE:
    per-sample sup-norm of |diff| / (std(diff, axis=0) + eps), the same as
    `modulation_func` + `ncf_metric_joint`. The diff and moments come from
    kernel K1 (`ns_joint_cp_diff_stats`)."""
    diff, s, sq = ns_joint_cp_diff_stats(truth, prediction, dt, dx, dy, nu,
                                         samples_per_block=samples_per_block,
                                         diff_dtype=diff_dtype)
    return _scores_from_diff_stats(diff, s, sq, truth.shape[0], eps)
