"""PRE stencil kernels: residuals (K2, K8), the joint-CP diff + moments (K1,
and K3 time-chunked) and the single-pass joint-CP scores (K9).

Port of `cppre/ops/pallas/stencil_kernels.py`, with its public names and
signatures (minus `interpret`). One CUDA source (`csrc/stencil_kernels.cu`)
holds the kernels, each a template over a *cell*, the residual at one output
cell: NS momentum, the five ideal-MHD equations, the two JOREK equations, or
a constant tap table (the wave composite kernel). Here a cell is a
`_Residual`: its CUDA kind and arguments, and its plain PyTorch math, which
is the plain version of every kernel it runs in.

* K2 `_batched_residual_fused`: fields [BS, Nvar, Nt, Nx, Ny] -> the
  interior residual [BS, Nt-2, Nx-2, Ny-2]. Instances
  `ns_momentum_residual_fused`, `mhd_residual_fused`,
  `mhd_induction_residual_fused`, `jorek_residual_fused`. A block stages
  the frames of one tile of one sample, a run of them, in shared memory
  once and evaluates the cell there (`_residual_geom`).
* K8 `fused_stencil_residual`: field [BS, Nt, Nx, Ny] and a constant odd
  k^3 kernel -> [BS, Nt-k+1, Nx-k+1, Ny-k+1], optionally |.|; the plain
  version is `stencil_shift_add(field, kernel, same=False)`. A block
  marches the frames of one tile of one sample through a ring in shared
  memory (`_march_geom`). `wave_residual_fused` names it for the wave
  experiment, `fused_stencil_same` runs it on the field zero-padded by
  k // 2 (the same-size correlation, the physics-informed loss's
  operator). Both are differentiable in the field: on the card the
  backward is K8 again (`fused_stencil_residual_bwd`, the valid
  correlation of the zero-padded cotangent with the flipped stencil,
  counted apart from the forward), on the CPU autograd of the plain
  version.
* K1 `_joint_cp_diff_stats`: truth and prediction read once; its instances
  return (diff [BS, *out], sum [*out], sumsq [*out]), diff = PRE(truth) - PRE(pred),
  optionally stored as bfloat16 (`diff_dtype`; the moments always come
  from the float32 diff). Instances `ns_joint_cp_diff_stats`,
  `wave_joint_cp_diff_stats`, `mhd_joint_cp_diff_stats`.
* K1, K3 and K8 (and the flat K10) take a tap table by value, in the
  kernel's parameters, where its count has a compile-time instance
  (`_taps_by_value`), and read the device copy of the same table
  otherwise; the other kernels always read the device copy. Every form
  adds the taps in `_tap_table`'s order.
* K3 `_joint_cp_diff_stats_chunked`: K1's outputs for 3-wide cells; a
  block walks the batch in sample order over one tile and chunk of output
  frames, streaming each sample's frames through shared memory, so its
  bits are K1's. Instances `ns_/wave_/mhd_/jorek_joint_cp_diff_stats_chunked`
  (the wave one for 3-wide kernels only); `t_block` bounds the frames a
  block takes (`_chunk_t_block`, the card's launch `_chunk_geom`).
* The joint-CP scores [BS]
  (`ns_/wave_/mhd_induction_/jorek_joint_cp_scores_fused`): K1 (or K3, by
  `routing_decision`) followed by the `_scores_from_diff_stats`
  epilogue in plain torch, as in the JAX package; or, with `single_pass=True` (NS and MHD entries), K9
  `_joint_cp_scores_single_pass`, one launch and no diff tensor. On the
  card `single_pass=True` always launches K9: a block keeps its 64 (or
  32) cells' diffs over the batch in shared memory, and a batch too large
  for that takes K9's recompute body (`_k9_grid`), so the TPU's VMEM fit
  test (`single_pass_fits`) has no counterpart. The scores are those of
  the two-pass route.

The modulation std of the scores comes from the centred sum of squares
sum_b (d_b - mean)^2, a second pass over the batch (K1 forms it when the
scores ask for it, K9 always), not from the JAX package's one-pass
sumsq / n - mean^2: in float32 that difference cancels when a cell's diff
varies over the batch by less than ~1e-3 of its mean, as it does where an
untrained or lightly trained surrogate predicts nearly the same residual
for every sample, and the sup-norm score peaks in exactly those cells.
The scores then agree with `modulation_func` + `ncf_metric_joint` (a
two-pass std) where the one-pass formula does not.

`routing_decision` (a pure function of the shape) sends the routed
entries (`*_joint_cp_diff_stats`, `*_joint_cp_scores_fused` two-pass) to K1
('paired') or K3 ('chunked'). The card timed the routed scores through K3
faster at no shape in every turn, so it says 'paired' throughout; cppre's
'composed' route answers a TPU VMEM limit that K1 does not have, and has
no counterpart.

The JOREK cell reads the major radius R of each row from a device table of
the input grid's values, so any grid takes the kernels; cppre rebuilds an
affine R inside its kernel and sends any other grid to XLA.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each kernel counts its launches, every instance together,
on the function named above (`launch_counts()` in `ops.kernels`).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..convops import stencil_shift_add
from . import _build

__all__ = [
    "fused_stencil_residual",
    "fused_stencil_residual_plain",
    "fused_stencil_residual_bwd",
    "fused_stencil_residual_bwd_plain",
    "fused_stencil_same",
    "fused_stencil_same_plain",
    "wave_residual_fused",
    "ns_momentum_residual_fused",
    "ns_momentum_residual_plain",
    "mhd_residual_fused",
    "mhd_residual_plain",
    "mhd_induction_residual_fused",
    "ns_joint_cp_diff_stats",
    "ns_joint_cp_diff_stats_plain",
    "wave_joint_cp_diff_stats",
    "wave_joint_cp_diff_stats_plain",
    "mhd_joint_cp_diff_stats",
    "mhd_joint_cp_diff_stats_plain",
    "ns_joint_cp_scores_fused",
    "ns_joint_cp_scores_plain",
    "wave_joint_cp_scores_fused",
    "wave_joint_cp_scores_plain",
    "mhd_induction_joint_cp_scores_fused",
    "mhd_induction_joint_cp_scores_plain",
    "ns_joint_cp_diff_stats_chunked",
    "ns_joint_cp_diff_stats_chunked_plain",
    "wave_joint_cp_diff_stats_chunked",
    "wave_joint_cp_diff_stats_chunked_plain",
    "mhd_joint_cp_diff_stats_chunked",
    "mhd_joint_cp_diff_stats_chunked_plain",
    "jorek_residual_fused",
    "jorek_residual_plain",
    "jorek_joint_cp_scores_fused",
    "jorek_joint_cp_scores_plain",
    "jorek_joint_cp_diff_stats_chunked",
    "jorek_joint_cp_diff_stats_chunked_plain",
    "routing_decision",
    "MHD_EQUATIONS",
    "JOREK_EQUATIONS",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C types of a cell's arguments after its kind: the five NS constants,
# the tap table (offsets, weights, count), JOREK's rows table, D and K
_CELL_TYPES = (_F, _F, _F, _F, _F, _P, _P, _I, _P, _F, _F)
# K1 and K8 also take the tap table's host copy, to pass it by value
_BY_VALUE_TYPES = (_P, _P)
MHD_EQUATIONS = ("continuity", "momentum", "energy", "induction", "gauss")
JOREK_EQUATIONS = ("continuity", "temperature")
GAMMA = 5.0 / 3.0


def _interior(a):
    return a[..., 1:-1, 1:-1, 1:-1]


def _d_t(a):
    return a[..., 2:, 1:-1, 1:-1] - a[..., :-2, 1:-1, 1:-1]


def _d_x(a):
    return a[..., 1:-1, 2:, 1:-1] - a[..., 1:-1, :-2, 1:-1]


def _d_y(a):
    return a[..., 1:-1, 1:-1, 2:] - a[..., 1:-1, 1:-1, :-2]


def _d_xx(a):
    return a[..., 1:-1, 2:, 1:-1] - 2.0 * _interior(a) + a[..., 1:-1, :-2, 1:-1]


def _d_yy(a):
    return a[..., 1:-1, 1:-1, 2:] - 2.0 * _interior(a) + a[..., 1:-1, 1:-1, :-2]


def _d_lap(a):
    return (a[..., 1:-1, 2:, 1:-1] + a[..., 1:-1, :-2, 1:-1]
            + a[..., 1:-1, 1:-1, 2:] + a[..., 1:-1, 1:-1, :-2] - 4.0 * _interior(a))


_GRID_OPS = (_interior, _d_t, _d_x, _d_y, _d_lap)


def _coef(dt, dx, dy, nu):
    """The float32 constants of the NS residual, in the kernels' order."""
    f = lambda v: float(np.float32(v))
    return f(dx * dy), f(dt * dy), f(dt * dx), f(nu), f(dt)


def _ns_momentum_math(fields, dt, dx, dy, nu, ops=_GRID_OPS):
    """The momentum residual on the interior window of [..., Nvar, Nt, Nx, Ny]
    fields, every derivative a shifted slice, in the term order of
    `cppre.ops.pallas.stencil_kernels._ns_momentum_math`. `ops` are the
    window and derivatives (the flat layout passes its own)."""
    cxy, cty, ctx, nu, dt = _coef(dt, dx, dy, nu)
    I, d_t, d_x, d_y, d_lap = ops
    u, v, p = fields[:, 0], fields[:, 1], fields[:, 2]
    ui, vi = I(u), I(v)
    res_x = (d_t(u) * cxy + ui * d_x(u) * cty + vi * d_y(u) * ctx
             - nu * d_lap(u) * dt + d_x(p) * cty)
    res_y = (d_t(v) * cxy + ui * d_x(v) * ctx + vi * d_y(v) * cty
             - nu * d_lap(v) * dt + d_y(p) * ctx)
    return res_x + res_y


def _mhd_math(equation, fields, ops=_GRID_OPS):
    """The ideal-MHD residual `equation` on the interior window of
    [BS, 6, Nt, Nx, Ny] fields (rho, u, v, p, Bx, By), in the term order of
    `cppre.ops.pallas.stencil_kernels._mhd_math`; `ops` as for
    `_ns_momentum_math`."""
    rho, u, v, p, Bx, By = (fields[:, i] for i in range(6))
    I, d_t, d_x, d_y, _ = ops
    if equation == "continuity":
        return (d_t(rho) + I(u) * d_x(rho) + I(rho) * d_x(u)
                + I(v) * d_y(rho) + I(rho) * d_y(v))
    if equation == "momentum":
        inv_rho = 1.0 / I(rho)
        res_x = (d_t(u) + I(u) * d_x(u) + inv_rho * d_x(p)
                 - 2 * (I(Bx) * inv_rho) * d_x(Bx) + I(v) * d_y(u)
                 - (I(By) * inv_rho) * d_y(Bx) - (I(Bx) * inv_rho) * d_y(By))
        res_y = (d_t(v) + I(u) * d_x(v) + inv_rho * d_y(p)
                 - 2 * (I(By) * inv_rho) * d_y(By) + I(v) * d_y(v)
                 - (I(By) * inv_rho) * d_x(Bx) - (I(Bx) * inv_rho) * d_x(By))
        return res_x + res_y
    if equation == "energy":
        p_gas = I(p) - 0.5 * (I(Bx) ** 2 + I(By) ** 2)
        return (d_t(rho) + I(u) * d_x(p) + I(v) * d_y(p)
                + (GAMMA - 2) * (I(u) * I(Bx) + I(v) * I(By)) * (d_x(Bx) + d_y(By))
                + (GAMMA * p_gas + I(By) ** 2) * d_x(u)
                + (GAMMA * p_gas + I(Bx) ** 2) * d_y(v)
                - I(Bx) * I(By) * (d_y(u) + d_x(v)))
    if equation == "induction":
        res_x = d_t(Bx) - I(By) * d_y(u) + I(Bx) * d_y(v) - I(v) * d_y(Bx) + I(u) * d_y(By)
        res_y = d_t(By) + I(By) * d_x(u) - I(Bx) * d_x(v) - I(v) * d_x(Bx) + I(u) * d_x(By)
        return res_x + res_y
    # gauss
    return d_x(Bx) + d_y(By)


def _jorek_math(equation, fields, R, Dc, K):
    """The JOREK reduced-MHD residual `equation` on the interior window of
    [BS, 3, Nt, NR, NZ] fields (rho, Phi, T), in the term order of
    `cppre.ops.pallas.stencil_kernels._jorek_math`: R-weighted Poisson
    brackets, 1/R terms, gamma = 5/3. R is the float32 1-D grid of the NR
    major radii; the interior rows take R[1:-1]."""
    rho, phi, T = fields[:, 0], fields[:, 1], fields[:, 2]
    r = torch.as_tensor(R[1:-1], device=fields.device)[:, None]
    I, d_t, d_x, d_y = _interior, _d_t, _d_x, _d_y
    br = lambda a, b: d_x(a) * d_y(b) - d_x(b) * d_y(a)
    if equation == "continuity":
        return (d_t(rho) - r * br(rho, phi) - 2.0 * I(rho) * d_y(phi)
                - Dc * (_d_xx(rho) + (1.0 / r) * d_x(rho) + _d_yy(rho)))
    return (I(T) * d_t(rho) + I(rho) * d_t(T)
            - I(rho) * r * br(T, phi) + I(T) * r * br(rho, phi)
            + 2.0 * GAMMA * I(rho) * I(T) * d_y(phi)
            + K * (_d_xx(T) + (1.0 / r) * d_x(T) + _d_yy(T)))


# ---- cells --------------------------------------------------------------------

class _Residual(NamedTuple):
    """One residual as the kernels take it: the CUDA cell kind (see
    `csrc/stencil_cells.cuh`), the fields it needs, the stencil extent k
    (outputs are N - k + 1 on each axis), the NS constants, the tap kernel,
    JOREK's rows (the float32 major radius of each of the Nx rows) and its
    (D, K), and the plain math [BS, Nvar, Nt, Nx, Ny] -> [BS, *out] (for NS
    and MHD it takes `ops=`, the window and derivatives of another layout)."""
    kind: int
    nvar: int
    k: int
    math: Callable
    coef: tuple = (0.0,) * 5
    kernel: np.ndarray | None = None
    rows: np.ndarray | None = None
    jc: tuple = (0.0, 0.0)


def _ns_cell(dt, dx, dy, nu):
    return _Residual(0, 3, 3, functools.partial(_ns_momentum_math, dt=dt, dx=dx, dy=dy, nu=nu),
                     _coef(dt, dx, dy, nu))


def _mhd_cell(equation):
    if equation not in MHD_EQUATIONS:
        raise ValueError(f"unknown MHD equation {equation!r}")
    return _Residual(1 + MHD_EQUATIONS.index(equation), 6, 3,
                     functools.partial(_mhd_math, equation))


def _jorek_cell(R, Dc, K, equation):
    """The JOREK cell: `equation` over the 1-D major-radius grid R (numpy,
    a tensor, or [NR, 1]), D and K as float32."""
    if equation not in JOREK_EQUATIONS:
        raise ValueError(f"unknown JOREK equation {equation!r}")
    if torch.is_tensor(R):
        R = R.detach().cpu().numpy()
    rows = np.asarray(R, np.float32)
    if rows.ndim == 2 and rows.shape[1] == 1:
        rows = rows[:, 0]
    if rows.ndim != 1:
        raise ValueError(f"R must be the 1-D major-radius grid (or [NR, 1]), got {rows.shape}")
    rows = np.ascontiguousarray(rows)
    dc, kc = float(np.float32(Dc)), float(np.float32(K))
    return _Residual(7 + JOREK_EQUATIONS.index(equation), 3, 3,
                     functools.partial(_jorek_math, equation, R=rows, Dc=dc, K=kc),
                     rows=rows, jc=(dc, kc))


def _taps_cell(kernel):
    kernel = np.asarray(kernel)
    k = kernel.shape[0]
    if kernel.ndim != 3 or kernel.shape != (k, k, k) or k % 2 != 1:
        raise ValueError(f"stencil kernels must be [k, k, k] with odd k, got {kernel.shape}")
    return _Residual(6, 1, k, lambda f: stencil_shift_add(f[:, 0], kernel, same=False),
                     kernel=kernel)


@functools.lru_cache(maxsize=64)
def _tap_table(kernel_bytes, k, dtype, nx, ny, plane=None):
    """The non-zero taps of a [k, k, k] kernel in `_taps` order
    (itertools.product, zeros dropped): int32 linear offsets for an
    [Nt, Nx, Ny] field (or a window of those strides; frames `plane`
    floats apart where given, else Nx Ny) and float32 weights, as read-only
    numpy arrays. K1 and K8 pass this host table by value where its count
    has an instance (`_taps_by_value`); the other kernels, and those two for
    any other count, read its device copy (`_tap_table_device`)."""
    kernel = np.frombuffer(kernel_bytes, dtype=dtype).reshape(k, k, k)
    taps = [idx for idx in itertools.product(range(k), repeat=3) if kernel[idx] != 0.0]
    plane = nx * ny if plane is None else plane
    off = np.array([it * plane + ix * ny + iy for it, ix, iy in taps], np.int32)
    w = np.array([kernel[idx] for idx in taps], np.float32)
    off.setflags(write=False)
    w.setflags(write=False)
    return off, w


@functools.lru_cache(maxsize=32)
def _tap_table_device(kernel_bytes, k, dtype, nx, ny, plane, device):
    """`_tap_table` on `device`."""
    off, w = _tap_table(kernel_bytes, k, dtype, nx, ny, plane)
    return (torch.tensor(off.tolist(), dtype=torch.int32, device=device),
            torch.tensor(w.tolist(), dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _taps_by_value(n: int) -> bool:
    """Whether K1 and K8 take a table of n taps by value (a compile-time
    instance of `TapsByValue<n>` in csrc/stencil_cells.cuh)."""
    lib = _build.library("stencil_kernels")
    return bool(_build.declare(lib, "cppre_taps_by_value", [_I])(n))


@functools.lru_cache(maxsize=32)
def _rows_table(rows_bytes, device):
    """JOREK's float32 major radii on `device`."""
    return torch.tensor(np.frombuffer(rows_bytes, dtype=np.float32), device=device)


def _cell_args(res: _Residual, shape, device, by_value: bool = False, plane=None):
    """The cell arguments of the C interface (`_CELL_TYPES` after the
    kind): kind, the five NS constants, the tap table (device pointers and
    count, 0 for the other cells), JOREK's rows table and (D, K); with
    `by_value` (K1, K8), then the host table's two pointers (`_BY_VALUE_TYPES`),
    set where the kernel takes the table by value, when the device table is
    not made. Also the tables, which the caller holds over the launch. The
    tap table is built for the strides of shape[-2:] (frames `plane` floats
    apart where given: K11's ring)."""
    tables, taps, rows, host = (), (None, None, 0), (None, 0.0, 0.0), (None, None)
    if res.kernel is not None:
        kern = np.ascontiguousarray(res.kernel)
        key = (kern.tobytes(), res.k, kern.dtype.str, shape[-2], shape[-1], plane)
        off, w = _tap_table(*key)
        if by_value and _taps_by_value(off.size):
            tables, taps, host = (off, w), (None, None, off.size), (off.ctypes.data, w.ctypes.data)
        else:
            d_off, d_w = _tap_table_device(*key, device)
            tables, taps = (d_off, d_w), (d_off.data_ptr(), d_w.data_ptr(), off.size)
    if res.rows is not None:
        r = _rows_table(res.rows.tobytes(), device)
        tables, rows = tables + (r,), (r.data_ptr(), *res.jc)
    return (res.kind, *res.coef, *taps, *rows) + (host if by_value else ()), tables


def _check_fields(fields, res: _Residual, what):
    if (fields.ndim != 5 or fields.shape[1] < res.nvar
            or min(fields.shape[2:]) < res.k):
        raise ValueError(f"{what}: expected [BS, Nvar>={res.nvar}, Nt, Nx, Ny] fields with "
                         f"every axis >= {res.k}, got {tuple(fields.shape)}")
    if res.rows is not None and res.rows.shape[0] != fields.shape[3]:
        raise ValueError(f"{what}: R has {res.rows.shape[0]} rows, the fields "
                         f"{fields.shape[3]}")


def _out_shape(shape, k):
    return tuple(n - k + 1 for n in shape[2:])


# ---- K2: the residual -----------------------------------------------------------

def _launch_residual(fields, res: _Residual, what: str):
    _build.require(fields, what)
    bs, nvar, nt, nx, ny = fields.shape
    out = torch.empty((bs,) + _out_shape(fields.shape, res.k), device=fields.device,
                      dtype=torch.float32)
    cell, tables = _cell_args(res, fields.shape, fields.device)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_stencil_residual",
                        [_I, _P, _P, _I, _I, _I, _I, _I, *_CELL_TYPES[:5], *_CELL_TYPES[8:], _P])
    with torch.cuda.device(fields.device):
        rc = fn(cell[0], fields.data_ptr(), out.data_ptr(), bs, nvar, nt, nx, ny, *cell[1:6],
                *cell[9:], _build.stream_of(fields))
    _build.check(lib, rc, what)
    return out


def _residual_geom(shape, res: _Residual):
    """K2's launch for [BS, Nvar, Nt, Nx, Ny] fields and cell `res` on this
    card, as the library chooses it: blocks, threads (a block), smem (bytes),
    tile (output rows, columns), frames (output frames a block runs), runs
    (of the output frames) and windows (the variables staged)."""
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_stencil_residual_geom", [_I] * 6 + [_P])
    g = (ctypes.c_longlong * 8)()
    _build.check(lib, fn(res.kind, *shape, g), "K2 geometry")
    g = [int(v) for v in g]
    return dict(blocks=g[0], threads=g[1], smem=g[2], tile=(g[3], g[4]), frames=g[5],
                runs=g[6], windows=g[7])


def _batched_residual_fused(fields, res: _Residual, what: str = "residual"):
    """Kernel K2: the per-sample interior residual of cell `res`."""
    _check_fields(fields, res, what)
    if not _build.on_cuda(fields):
        return res.math(fields)
    out = _launch_residual(fields, res, what)
    _batched_residual_fused.launches += 1
    return out


_batched_residual_fused.launches = 0


def ns_momentum_residual_plain(fields, dt: float, dx: float, dy: float, nu: float = 0.001):
    """Plain PyTorch NS momentum residual: [BS, Nvar, Nt, Nx, Ny] -> [BS, Nt-2, Nx-2, Ny-2]."""
    res = _ns_cell(dt, dx, dy, nu)
    _check_fields(fields, res, "ns_momentum_residual")
    return res.math(fields)


def ns_momentum_residual_fused(fields, dt: float, dx: float, dy: float, nu: float = 0.001):
    """Fused NS momentum PRE (kernel K2): fields [BS, Nvar>=3, Nt, Nx, Ny]
    (u, v, p) -> interior residual [BS, Nt-2, Nx-2, Ny-2], equal to
    `PRE_NS.residual_momentum(fields, boundary=False)`."""
    return _batched_residual_fused(fields, _ns_cell(dt, dx, dy, nu),
                                   "ns_momentum_residual_fused")


def mhd_residual_plain(fields, equation: str = "induction"):
    """Plain PyTorch `mhd_residual_fused`."""
    res = _mhd_cell(equation)
    _check_fields(fields, res, "mhd_residual")
    return res.math(fields)


def mhd_residual_fused(fields, equation: str = "induction"):
    """Fused ideal-MHD PRE (kernel K2) for any of the five selectable
    equations: fields [BS, 6, Nt, Nx, Ny] (rho, u, v, p, Bx, By) -> interior
    residual [BS, Nt-2, Nx-2, Ny-2], equal to `PRE_MHD.residual(fields,
    equation, boundary=False)`. The kernel reads only the fields the
    equation uses."""
    return _batched_residual_fused(fields, _mhd_cell(equation), "mhd_residual_fused")


def mhd_induction_residual_fused(fields):
    """Fused ideal-MHD induction PRE (see `mhd_residual_fused`)."""
    return mhd_residual_fused(fields, "induction")


def jorek_residual_plain(fields, R, Dc: float = 3.4, K: float = 2.25e-7,
                         equation: str = "continuity"):
    """Plain PyTorch `jorek_residual_fused`."""
    res = _jorek_cell(R, Dc, K, equation)
    _check_fields(fields, res, "jorek_residual")
    return res.math(fields)


def jorek_residual_fused(fields, R, Dc: float = 3.4, K: float = 2.25e-7,
                         equation: str = "continuity"):
    """Fused JOREK reduced-MHD PRE (kernel K2): fields [BS, 3, Nt, NR, NZ]
    (rho, Phi, T), R the 1-D major-radius grid (any grid: the kernel reads
    it from a table) -> interior residual [BS, Nt-2, NR-2, NZ-2], equal to
    `PRE_JOREK(R, ...).residual(fields, equation, boundary=False)`."""
    return _batched_residual_fused(fields, _jorek_cell(R, Dc, K, equation),
                                   "jorek_residual_fused")


def fused_stencil_residual_plain(field, kernel, take_abs: bool = False):
    """Plain PyTorch `fused_stencil_residual`."""
    res = stencil_shift_add(field, np.asarray(kernel), same=False)
    return res.abs() if take_abs else res


def fused_stencil_same_plain(field, kernel):
    """Plain PyTorch `fused_stencil_same`: `stencil_shift_add(same=True)`."""
    return stencil_shift_add(field, np.asarray(kernel), same=True)


def fused_stencil_residual_bwd_plain(cotangent, kernel, pad: int = 0):
    """Plain PyTorch `fused_stencil_residual_bwd`: torch autograd of
    `fused_stencil_residual_plain` over the field zero-padded by `pad`."""
    k = np.asarray(kernel).shape[0]
    shape = cotangent.shape[:1] + tuple(n + k - 1 - 2 * pad for n in cotangent.shape[1:])
    with torch.enable_grad():
        field = torch.zeros(shape, dtype=cotangent.dtype, device=cotangent.device,
                            requires_grad=True)
        out = fused_stencil_residual_plain(_pad3(field, pad), kernel)
        (grad,) = torch.autograd.grad(out, field, cotangent)
    return grad


# ---- K8: a constant stencil marching in time ---------------------------------

def _march_geom(shape, k: int):
    """(rows, rw, blocks) of K8 for a [BS, Nt, Nx, Ny] field and a k-wide
    stencil on the current card: a slot of its ring holds rows x rw floats
    of a frame, the strides its tap table is built for, and its grid has
    `blocks` blocks (it depends on the card's SM count)."""
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_fused_stencil_residual_geom", [_I] * 5 + [_P])
    geom = (ctypes.c_longlong * 3)()
    _build.check(lib, fn(*shape, k, geom), "K8 geometry")
    return tuple(int(v) for v in geom)


def _launch_march(field, res: _Residual, take_abs: bool, what: str):
    """Kernel K8 on a CUDA field [BS, Nt, Nx, Ny]; a k whose ring does not
    fit a block's shared memory is refused."""
    _build.require(field, what)
    bs, nt, nx, ny = field.shape
    out = torch.empty((bs,) + _out_shape(field[:, None].shape, res.k), device=field.device,
                      dtype=torch.float32)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_fused_stencil_residual",
                        [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, *_BY_VALUE_TYPES, _I, _P])
    with torch.cuda.device(field.device):
        rows, rw, _ = _march_geom(field.shape, res.k)
        cell, tables = _cell_args(res, (rows, rw), field.device, by_value=True)
        rc = fn(field.data_ptr(), out.data_ptr(), bs, nt, nx, ny, res.k, *cell[6:9],
                *cell[-2:], int(take_abs), _build.stream_of(field))
    _build.check(lib, rc, what)
    return out


def _pad3(field, pad: int):
    """Zero-pad the last three axes (t, x, y) of a [BS, Nt, Nx, Ny] field by
    `pad` on each side."""
    return torch.nn.functional.pad(field, (pad,) * 6) if pad else field


def _check_stencil_field(field, what):
    if field.ndim != 4:
        raise ValueError(f"{what}: expected [BS, Nt, Nx, Ny], got {tuple(field.shape)}")


def _adjoint_operands(cotangent, kernel, pad: int):
    """What K8's backward launches K8 on (`_StencilMarch`): the cotangent
    zero-padded by k - 1 - pad, contiguous, and the stencil flipped on all
    three axes."""
    k = kernel.shape[0]
    return (_pad3(cotangent, k - 1 - pad).contiguous(),
            np.ascontiguousarray(kernel[::-1, ::-1, ::-1]))


class _StencilMarch(torch.autograd.Function):
    """K8 with K8 as its backward. Forward: the valid correlation of the
    field, zero-padded by `pad` on each side of t, x and y, with the stencil
    K. Its adjoint: out[i] = sum_a K[a] f[i + a - pad] sends the cotangent g
    to grad[j] = sum_a K[a] g[j - a + pad] = sum_b flip(K)[b] g'[j + b],
    g' the cotangent zero-padded by k - 1 - pad and flip(K) K reversed on
    all three axes: the valid correlation of g' with flip(K), one more K8
    launch of the same output shape as the field
    (`fused_stencil_residual_bwd`)."""

    @staticmethod
    def forward(ctx, field, res, pad):
        ctx.kernel, ctx.pad = res.kernel, pad
        return _march(field, res, pad)

    @staticmethod
    def backward(ctx, g):
        return fused_stencil_residual_bwd(g, ctx.kernel, ctx.pad), None, None


def _march(field, res, pad: int, take_abs: bool = False):
    """K8 on the field zero-padded by `pad` (a padded copy is contiguous)."""
    field = _pad3(field, pad).contiguous() if pad else field
    out = _launch_march(field, res, take_abs, "fused_stencil_residual")
    fused_stencil_residual.launches += 1
    return out


def _march_differentiable(field, res, pad: int):
    """K8, through `_StencilMarch` where autograd needs its backward, else
    the launch alone (no autograd node on the inference path)."""
    if torch.is_grad_enabled() and field.requires_grad:
        return _StencilMarch.apply(field, res, pad)
    return _march(field, res, pad)


def _refuse_abs_under_grad(field, take_abs):
    if take_abs and torch.is_grad_enabled() and field.requires_grad:
        raise ValueError("fused_stencil_residual(take_abs=True) has no gradient: the kernel "
                         "stores |D(field)| and drops the sign of D(field) that the backward "
                         "needs; differentiate take_abs=False and take .abs() of its result")


def fused_stencil_residual(field, kernel, take_abs: bool = False):
    """Kernel K8: a constant stencil on the valid interior, |D(field)| with
    `take_abs`. field [BS, Nt, Nx, Ny]; kernel a constant [k, k, k] (odd k)
    array. Returns [BS, Nt-k+1, Nx-k+1, Ny-k+1], the reference crop for
    k = 3. On the card a block marches the frames of one tile of one sample
    through a ring in shared memory; a k whose ring does not fit raises.
    Differentiable in the field: on the card its backward is K8 again
    (`fused_stencil_residual_bwd`), on the CPU autograd of the plain
    version; `take_abs` under grad raises."""
    res = _taps_cell(kernel)
    _check_stencil_field(field, "fused_stencil_residual")
    _check_fields(field[:, None], res, "fused_stencil_residual")
    _refuse_abs_under_grad(field, take_abs)
    if not _build.on_cuda(field):
        return fused_stencil_residual_plain(field, res.kernel, take_abs)
    if take_abs:
        return _march(field, res, 0, take_abs=True)
    return _march_differentiable(field, res, 0)


fused_stencil_residual.launches = 0


def fused_stencil_same(field, kernel):
    """Kernel K8 on the field zero-padded by k // 2 on each side of t, x and
    y: the same-size correlation `direct_conv(field, kernel, same=True)`
    (`PRE_Wave(...)(field, boundary=True)` for the wave kernel), field and
    result [BS, Nt, Nx, Ny]. Differentiable in the field: on the card its
    backward is K8 on the cotangent padded by k // 2 with the stencil
    flipped, on the CPU autograd of the plain version. Counts on K8."""
    res = _taps_cell(kernel)
    _check_stencil_field(field, "fused_stencil_same")
    if not _build.on_cuda(field):
        return fused_stencil_same_plain(field, res.kernel)
    return _march_differentiable(field, res, res.k // 2)


def fused_stencil_residual_bwd(cotangent, kernel, pad: int = 0):
    """K8's backward, itself a K8 launch: the gradient, with respect to the
    field, of sum(cotangent * fused_stencil_residual(field zero-padded by
    `pad`, kernel)). cotangent [BS, Mt, Mx, My] -> [BS, Mt+k-1-2 pad, ...]:
    K8 on the cotangent zero-padded by k - 1 - pad with the stencil flipped
    on all three axes (`_StencilMarch`). A non-contiguous cotangent is made
    contiguous. Counts its launches apart from the forward's."""
    kernel = np.asarray(kernel)
    _check_stencil_field(cotangent, "fused_stencil_residual_bwd")
    k = kernel.shape[0]
    if not 0 <= pad <= k // 2:
        raise ValueError(f"fused_stencil_residual_bwd: pad must lie in [0, {k // 2}], got {pad}")
    if not _build.on_cuda(cotangent):
        return fused_stencil_residual_bwd_plain(cotangent, kernel, pad)
    padded, flipped = _adjoint_operands(cotangent, kernel, pad)
    out = _launch_march(padded, _taps_cell(flipped), False, "fused_stencil_residual_bwd")
    fused_stencil_residual_bwd.launches += 1
    return out


fused_stencil_residual_bwd.launches = 0


def wave_residual_fused(field, kernel):
    """Fused wave composite-kernel PRE: field [BS, Nt, Nx, Ny], kernel the
    additive D_tt - (c dt/dx)^2 D_xxyy stencil. Kernel K8, named for the
    wave experiment."""
    return fused_stencil_residual(field, kernel)


# ---- K1: diff and moments ------------------------------------------------------

def _diff_stats_plain(truth, prediction, res: _Residual, diff_dtype=None, centred=False):
    diff = res.math(truth) - res.math(prediction)
    s, sq = torch.sum(diff, dim=0), torch.sum(diff * diff, dim=0)
    m2 = torch.sum((diff - s / truth.shape[0]) ** 2, dim=0) if centred else None
    return diff.to(diff_dtype or truth.dtype), s, sq, m2


def _check_pair(truth, prediction, res, what):
    _check_fields(truth, res, what)
    if tuple(prediction.shape) != tuple(truth.shape):
        raise ValueError(f"{what}: truth {tuple(truth.shape)} and prediction "
                         f"{tuple(prediction.shape)} differ in shape")


def _joint_cp_diff_stats(truth, prediction, res: _Residual, samples_per_block: int = 1,
                         diff_dtype=None, what: str = "joint_cp_diff_stats",
                         centred: bool = False):
    """Kernel K1: (diff [BS, *out], sum [*out], sumsq [*out], m2) of cell
    `res`, the moments summed over the batch in sample order; with
    `centred`, m2 [*out] is the centred sum of squares (else None).

    `diff_dtype=torch.bfloat16` stores the diff in bfloat16 (halving its
    write and the score pass's read); the moments still accumulate from
    the float32 diff. `samples_per_block` is accepted for signature parity
    with `cppre`: every thread of the kernel walks the whole batch, a few
    samples in flight, and folds them in sample order, so the result does
    not depend on it. A tap table goes by value where its count has an
    instance (`_taps_by_value`). Counts the launches of every K1 instance."""
    _check_pair(truth, prediction, res, what)
    if samples_per_block < 1:
        raise ValueError(f"samples_per_block must be >= 1, got {samples_per_block}")
    diff_dtype = diff_dtype or torch.float32
    if diff_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"diff_dtype must be float32 or bfloat16, got {diff_dtype}")
    if not _build.on_cuda(truth):
        return _diff_stats_plain(truth, prediction, res, diff_dtype, centred)
    _build.require(truth, "truth")
    _build.require(prediction, "prediction", truth.shape, device=truth.device)
    bs, nvar, nt, nx, ny = truth.shape
    out = _out_shape(truth.shape, res.k)
    diff = torch.empty((bs,) + out, device=truth.device, dtype=diff_dtype)
    s, sq = (torch.empty(out, device=truth.device, dtype=torch.float32) for _ in range(2))
    m2 = torch.empty(out, device=truth.device, dtype=torch.float32) if centred else None
    cell, tables = _cell_args(res, truth.shape, truth.device, by_value=True)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_joint_cp_diff_stats",
                        [_I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_CELL_TYPES,
                         *_BY_VALUE_TYPES, _P])
    with torch.cuda.device(truth.device):
        rc = fn(cell[0], truth.data_ptr(), prediction.data_ptr(), diff.data_ptr(),
                int(diff_dtype == torch.bfloat16), s.data_ptr(), sq.data_ptr(),
                None if m2 is None else m2.data_ptr(), bs, nvar, nt, nx, ny, res.k,
                *cell[1:], _build.stream_of(truth))
    _build.check(lib, rc, what)
    _joint_cp_diff_stats.launches += 1
    return diff, s, sq, m2


_joint_cp_diff_stats.launches = 0


def _k1_grid(shape, res: _Residual, diff_dtype=None):
    """(blocks, threads a block) of the K1 launch for [BS, Nvar, Nt, Nx, Ny]
    inputs and cell `res`: 64 cells of a frame a block, and 1 to 4 threads
    a cell, as many as keep every block resident at once on this card."""
    n = 0 if res.kernel is None else int(np.count_nonzero(res.kernel))
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_joint_cp_diff_stats_grid", [_I] * 9 + [_P])
    grid = (ctypes.c_longlong * 2)()
    _build.check(lib, fn(res.kind, int(diff_dtype == torch.bfloat16), *shape[1:], res.k, n,
                         int(n > 0 and _taps_by_value(n)), grid), "K1 grid")
    return int(grid[0]), int(grid[1])


def ns_joint_cp_diff_stats_plain(truth, prediction, dt: float, dx: float, dy: float,
                                 nu: float = 0.001, diff_dtype=None):
    """Plain PyTorch (diff, sum, sumsq) of `ns_joint_cp_diff_stats`."""
    res = _ns_cell(dt, dx, dy, nu)
    _check_pair(truth, prediction, res, "ns_joint_cp_diff_stats")
    return _diff_stats_plain(truth, prediction, res, diff_dtype)[:3]


def ns_joint_cp_diff_stats(truth, prediction, dt: float, dx: float, dy: float,
                           nu: float = 0.001, samples_per_block: int = 1, diff_dtype=None):
    """One-pass joint-CP front end over the NS momentum PRE: truth and
    prediction [BS, Nvar>=3, Nt, Nx, Ny] -> (diff [BS, Nt-2, Nx-2, Ny-2],
    sum, sumsq [Nt-2, Nx-2, Ny-2]) through kernel K1, or K3 where
    `routing_decision` picks it; see `_joint_cp_diff_stats`."""
    return _diff_stats_routed(truth, prediction, _ns_cell(dt, dx, dy, nu),
                              samples_per_block, diff_dtype, "ns_joint_cp_diff_stats")[:3]


def wave_joint_cp_diff_stats_plain(truth, prediction, kernel, diff_dtype=None):
    """Plain PyTorch (diff, sum, sumsq) of `wave_joint_cp_diff_stats`."""
    res = _taps_cell(kernel)
    _check_pair(truth[:, None], prediction[:, None], res, "wave_joint_cp_diff_stats")
    return _diff_stats_plain(truth[:, None], prediction[:, None], res, diff_dtype)[:3]


def wave_joint_cp_diff_stats(truth, prediction, kernel, samples_per_block: int = 1,
                             diff_dtype=None):
    """K1 (or, for k = 3, K3 by `routing_decision`) over a constant-stencil
    PRE (the wave composite kernel): truth and prediction [BS, Nt, Nx, Ny],
    kernel [k, k, k] with odd k -> (diff [BS, Nt-k+1, Nx-k+1, Ny-k+1], sum,
    sumsq)."""
    return _diff_stats_routed(truth[:, None], prediction[:, None], _taps_cell(kernel),
                              samples_per_block, diff_dtype, "wave_joint_cp_diff_stats")[:3]


def mhd_joint_cp_diff_stats_plain(truth, prediction, equation: str = "induction",
                                  diff_dtype=None):
    """Plain PyTorch (diff, sum, sumsq) of `mhd_joint_cp_diff_stats`."""
    res = _mhd_cell(equation)
    _check_pair(truth, prediction, res, "mhd_joint_cp_diff_stats")
    return _diff_stats_plain(truth, prediction, res, diff_dtype)[:3]


def mhd_joint_cp_diff_stats(truth, prediction, equation: str = "induction",
                            samples_per_block: int = 1, diff_dtype=None):
    """K1 (or K3 by `routing_decision`) over an ideal-MHD PRE: truth and
    prediction [BS, 6, Nt, Nx, Ny] -> (diff [BS, Nt-2, Nx-2, Ny-2], sum,
    sumsq)."""
    return _diff_stats_routed(truth, prediction, _mhd_cell(equation), samples_per_block,
                              diff_dtype, "mhd_joint_cp_diff_stats")[:3]


# ---- K3: diff and moments, time-chunked ------------------------------------------

# K3's window frame (csrc/stencil_kernels.cu, kChunkRows x kChunkRW floats a
# variable, a tile of 8 x 32 output cells and its halo), the frames it keeps
# in flight and the most output frames a block takes. A block's ring holds
# one window of t + 2 frame slots (two where t + 2 < kChunkAhead + 3), each
# slot the truth's and the prediction's frame of every variable from the
# first to the last the cell reads: `_chunk_t_block` mirrors the fit of
# `chunk_geom` there and `_chunk_window` a slot's strides (`ChunkWindow`);
# `_chunk_geom` reports the C side's launch.
_K3_ROWS, _K3_ROW = 10, 36
_K3_FRAME_FLOATS = _K3_ROWS * _K3_ROW
_K3_AHEAD = 2
_K3_MAX_T_BLOCK = 8
_SMEM_BYTES = 232448
# variables from the first to the last each cell kind reads (the span of
# `cell_vars` in csrc/stencil_cells.cuh), by kind
_CELL_WINDOWS = (3, 3, 6, 6, 5, 2, 1, 2, 3)


def _chunk_ring_bytes(t: int, windows: int) -> int:
    """Shared memory of a K3 ring at t output frames a block."""
    frames = -(-(_K3_AHEAD + 3) // (t + 2)) * (t + 2)
    return 4 * 2 * windows * _K3_FRAME_FLOATS * frames


def _chunk_window(res: _Residual):
    """The (rows, row length) of a K3 ring slot, the strides its tap table
    is built for: the truth's and the prediction's 10-row frames of each
    windowed variable, rows of 36 floats."""
    return 2 * _CELL_WINDOWS[res.kind] * _K3_ROWS, _K3_ROW


def _chunk_t_block(t_block: int, windows: int, ot: int) -> int:
    """The most output frames a K3 block takes for a requested `t_block`
    and a cell with `windows` variable windows: at most 8 and the
    interior's ot, with the rings of its chunks (the last one may be
    shorter) within a block's 227 KB of shared memory, as cppre cuts its
    t_block to fit VMEM. The card's launch may take fewer where that fills
    its SMs in fewer steps (`_chunk_geom`). Raises if one frame does not
    fit."""
    if t_block < 1:
        raise ValueError(f"t_block must be >= 1, got {t_block}")

    def fits(t):
        last = ot - (-(-ot // t) - 1) * t if ot >= 1 else t
        return max(_chunk_ring_bytes(t, windows), _chunk_ring_bytes(last, windows)) <= _SMEM_BYTES

    t = max(1, min(t_block, _K3_MAX_T_BLOCK, ot))
    while t > 1 and not fits(t):
        t -= 1
    if not fits(t):
        raise ValueError(f"K3: {windows} variable windows do not fit shared memory even at "
                         f"t_block=1")
    return t


def _chunk_geom(shape, res: _Residual, t_block: int = 5):
    """K3's launch for [BS, Nvar, Nt, Nx, Ny] inputs, cell `res` and
    `t_block` on this card, as the library chooses it: blocks, threads (a
    block), smem (bytes), tile (output rows, columns), frames (output frames
    a block takes), chunks (of the output frames), windows (variables
    staged), window (a ring slot's rows, both tensors' frames of each
    windowed variable, and its row length: `_chunk_window`), ring (the
    largest ring's frame slots) and per_sm (blocks an SM holds). For
    reports and tests; a launch needs none of it."""
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_joint_cp_diff_stats_chunked_geom", [_I] * 7 + [_P])
    g = (ctypes.c_longlong * 12)()
    _build.check(lib, fn(res.kind, *shape, t_block, g), "K3 geometry")
    g = [int(v) for v in g]
    return dict(blocks=g[0], threads=g[1], smem=g[2], tile=(g[3], g[4]), frames=g[5],
                chunks=g[6], windows=g[7], window=(g[8], g[9]), ring=g[10], per_sm=g[11])


def _joint_cp_diff_stats_chunked(truth, prediction, res: _Residual, t_block: int = 5,
                                 centred: bool = False,
                                 what: str = "joint_cp_diff_stats_chunked"):
    """Kernel K3: K1's (diff, sum, sumsq, m2) for a 3-wide cell, each
    block's tile and chunk of frames streamed through shared memory while
    it walks the batch in sample order. The cell and the order are K1's, so
    are the bits; `t_block` bounds the frames a block takes
    (`_chunk_t_block`, `_chunk_geom`) and changes which block computes a
    cell, never its value. The diff is float32. A tap table goes by value
    where its count has an instance. Counts the launches of every K3
    instance."""
    _check_pair(truth, prediction, res, what)
    if res.k != 3 or truth.shape[0] < 1:
        raise ValueError(f"{what}: the chunked kernel takes 3-wide stencils and a batch, "
                         f"got k={res.k}, {tuple(truth.shape)}")
    _chunk_t_block(t_block, _CELL_WINDOWS[res.kind], truth.shape[2] - 2)
    if not _build.on_cuda(truth):
        return _diff_stats_plain(truth, prediction, res, None, centred)
    _build.require(truth, "truth")
    _build.require(prediction, "prediction", truth.shape, device=truth.device)
    bs, nvar, nt, nx, ny = truth.shape
    out = _out_shape(truth.shape, 3)
    diff = torch.empty((bs,) + out, device=truth.device, dtype=torch.float32)
    s, sq = (torch.empty(out, device=truth.device, dtype=torch.float32) for _ in range(2))
    m2 = torch.empty(out, device=truth.device, dtype=torch.float32) if centred else None
    cell, tables = _cell_args(res, _chunk_window(res), truth.device, by_value=True)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_joint_cp_diff_stats_chunked",
                        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_CELL_TYPES,
                         *_BY_VALUE_TYPES, _P])
    with torch.cuda.device(truth.device):
        rc = fn(cell[0], truth.data_ptr(), prediction.data_ptr(), diff.data_ptr(),
                s.data_ptr(), sq.data_ptr(), None if m2 is None else m2.data_ptr(),
                bs, nvar, nt, nx, ny, t_block, *cell[1:], _build.stream_of(truth))
    _build.check(lib, rc, what)
    _joint_cp_diff_stats_chunked.launches += 1
    return diff, s, sq, m2


_joint_cp_diff_stats_chunked.launches = 0


def ns_joint_cp_diff_stats_chunked(truth, prediction, dt: float, dx: float, dy: float,
                                   nu: float = 0.001, t_block: int = 5):
    """NS-momentum instance of K3: truth and prediction [BS, Nvar>=3, Nt, Nx,
    Ny] -> (diff [BS, Nt-2, Nx-2, Ny-2], sum, sumsq [Nt-2, Nx-2, Ny-2]), the
    contract of `ns_joint_cp_diff_stats`."""
    return _joint_cp_diff_stats_chunked(truth, prediction, _ns_cell(dt, dx, dy, nu), t_block,
                                        what="ns_joint_cp_diff_stats_chunked")[:3]


def ns_joint_cp_diff_stats_chunked_plain(truth, prediction, dt: float, dx: float, dy: float,
                                         nu: float = 0.001, t_block: int = 5):
    """Plain PyTorch `ns_joint_cp_diff_stats_chunked` (`t_block` only checked)."""
    _chunk_t_block(t_block, _CELL_WINDOWS[0], truth.shape[2] - 2)
    return ns_joint_cp_diff_stats_plain(truth, prediction, dt, dx, dy, nu)


def _wave_cell_3(kernel, what):
    res = _taps_cell(kernel)
    if res.k != 3:
        raise ValueError(f"{what}: the chunked route takes a 3-wide kernel (one-frame time "
                         f"halo), got {res.kernel.shape}")
    return res


def wave_joint_cp_diff_stats_chunked(truth, prediction, kernel, t_block: int = 5):
    """Wave-composite instance of K3 for 3-wide kernels: truth and
    prediction [BS, Nt, Nx, Ny] single-variable trajectories -> (diff, sum,
    sumsq) as `wave_joint_cp_diff_stats`. Raises on any other width."""
    res = _wave_cell_3(kernel, "wave_joint_cp_diff_stats_chunked")
    return _joint_cp_diff_stats_chunked(truth[:, None], prediction[:, None], res, t_block,
                                        what="wave_joint_cp_diff_stats_chunked")[:3]


def wave_joint_cp_diff_stats_chunked_plain(truth, prediction, kernel, t_block: int = 5):
    """Plain PyTorch `wave_joint_cp_diff_stats_chunked`."""
    _wave_cell_3(kernel, "wave_joint_cp_diff_stats_chunked")
    _chunk_t_block(t_block, _CELL_WINDOWS[6], truth.shape[1] - 2)
    return wave_joint_cp_diff_stats_plain(truth, prediction, kernel)


def mhd_joint_cp_diff_stats_chunked(truth, prediction, equation: str = "induction",
                                    t_block: int = 5):
    """MHD instance of K3 for any of the five equations: truth and
    prediction [BS, 6, Nt, Nx, Ny] -> (diff, sum, sumsq) as
    `mhd_joint_cp_diff_stats`. Stages only the variables the equation reads."""
    return _joint_cp_diff_stats_chunked(truth, prediction, _mhd_cell(equation), t_block,
                                        what="mhd_joint_cp_diff_stats_chunked")[:3]


def mhd_joint_cp_diff_stats_chunked_plain(truth, prediction, equation: str = "induction",
                                          t_block: int = 5):
    """Plain PyTorch `mhd_joint_cp_diff_stats_chunked`."""
    _chunk_t_block(t_block, _CELL_WINDOWS[_mhd_cell(equation).kind], truth.shape[2] - 2)
    return mhd_joint_cp_diff_stats_plain(truth, prediction, equation)


def jorek_joint_cp_diff_stats_chunked(truth, prediction, R, Dc: float = 3.4, K: float = 2.25e-7,
                                      equation: str = "continuity", t_block: int = 5):
    """JOREK instance of K3: truth and prediction [BS, 3, Nt, NR, NZ] ->
    (diff [BS, Nt-2, NR-2, NZ-2], sum, sumsq [Nt-2, NR-2, NZ-2]). The
    window's rows take their R from the input grid's table, so a
    non-affine R runs the kernel too."""
    return _joint_cp_diff_stats_chunked(truth, prediction, _jorek_cell(R, Dc, K, equation),
                                        t_block, what="jorek_joint_cp_diff_stats_chunked")[:3]


def jorek_joint_cp_diff_stats_chunked_plain(truth, prediction, R, Dc: float = 3.4,
                                            K: float = 2.25e-7, equation: str = "continuity",
                                            t_block: int = 5):
    """Plain PyTorch `jorek_joint_cp_diff_stats_chunked` (`t_block` only checked)."""
    res = _jorek_cell(R, Dc, K, equation)
    _check_pair(truth, prediction, res, "jorek_joint_cp_diff_stats_chunked")
    _chunk_t_block(t_block, _CELL_WINDOWS[res.kind], truth.shape[2] - 2)
    return _diff_stats_plain(truth, prediction, res)[:3]


# ---- routing: K1 or K3 --------------------------------------------------------------

def routing_decision(shape, out_shape=None, has_chunked: bool = True) -> str:
    """Which kernel the routed joint-CP entries launch for [BS, nvar, nt, nx,
    ny] inputs on the card: 'paired' (K1) or 'chunked' (K3, only for a cell
    with a chunked instance, `has_chunked`). A pure function of the shape.
    cppre's third route, 'composed', exists because its paired kernel needs
    whole trajectories in VMEM; K1 has no such ceiling here.

    K1 everywhere, as timed on an H100 (PERF.md, `tools/stencil_vs_parent.py`).
    K3 streams its windows through shared memory and runs within a few per
    cent of K1 at cppre's grid-scaling shapes, 1-3 % ahead without the
    centred pass at MHD induction [25, 6, 21, 256, 256] and JOREK continuity
    [12, 3, 21, 512, 512]. The routed scores take the centred pass, whose
    K3 form reads each thread's stored diffs back one sample after another:
    through K3 they won at neither shape nor at a batch of 32 in every
    turn of two calls (level within the turns' spread at MHD and at JOREK's
    batch of 12, 7 % behind K1 at JOREK's batch of 32). At the flagship
    shapes' batches of 100 or more K1 leads by far. The explicit
    `*_joint_cp_diff_stats_chunked` entries always launch K3."""
    return "paired"


def _diff_stats_routed(truth, prediction, res: _Residual, samples_per_block, diff_dtype,
                       what, centred=False):
    """K1 or K3 by `routing_decision`, with K1's outputs (diff, sum, sumsq,
    m2); a bfloat16 `diff_dtype` is applied after K3, as cppre casts after
    its chunked kernel."""
    route = routing_decision(tuple(truth.shape), _out_shape(truth.shape, res.k), res.k == 3)
    if route == "chunked":
        diff, s, sq, m2 = _joint_cp_diff_stats_chunked(truth, prediction, res, centred=centred,
                                                       what=what)
        return diff.to(diff_dtype or torch.float32), s, sq, m2
    return _joint_cp_diff_stats(truth, prediction, res, samples_per_block, diff_dtype, what,
                                centred)


# ---- scores: K1 + epilogue, or K9 ----------------------------------------------

def _scores_from_diff_stats(diff, m2, n: int, eps: float):
    """Modulation std from the centred sum of squares, then the per-sample
    sup-norm score (modulation_func + ncf_metric_joint). A bfloat16 diff is
    upcast first, so the score arithmetic is float32."""
    mod = torch.sqrt(m2 / n) + eps
    r = diff.to(m2.dtype).abs() / mod
    return torch.amax(r, dim=tuple(range(1, diff.ndim)))


# K9 keeps sample b's score at word b * _SCORE_STRIDE, one 128-byte line
# each, so that the blocks' atomic maxima for different samples do not queue
# on one line of L2 (on the H100 a tenth of K9's time with the scores side by
# side, PERF.md).
_SCORE_STRIDE = 32


def _joint_cp_scores_single_pass(truth, prediction, res: _Residual, eps: float,
                                 what: str = "joint_cp_scores_single_pass"):
    """Kernel K9: the joint-CP scores [BS] of cell `res` in one launch that
    writes no diff tensor: each block keeps its cells' diffs in shared
    memory, or for a batch too large for that recomputes them (`_k9_grid`).
    Equal to the two-pass route's scores: the same cell forms each diff,
    the sum and the centred sum of squares are taken in the same order and
    rounding, and a maximum does not depend on the order it is taken in."""
    _check_pair(truth, prediction, res, what)
    if not _build.on_cuda(truth):
        d, _, _, m2 = _diff_stats_plain(truth, prediction, res, centred=True)
        return _scores_from_diff_stats(d, m2, truth.shape[0], eps)
    _build.require(truth, "truth")
    _build.require(prediction, "prediction", truth.shape, device=truth.device)
    bs, nvar, nt, nx, ny = truth.shape
    bits = torch.zeros(bs * _SCORE_STRIDE, device=truth.device, dtype=torch.int32)
    cell, tables = _cell_args(res, truth.shape, truth.device)
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_joint_cp_scores_single_pass",
                        [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *_CELL_TYPES, _F, _P])
    with torch.cuda.device(truth.device):
        rc = fn(cell[0], truth.data_ptr(), prediction.data_ptr(), bits.data_ptr(),
                _SCORE_STRIDE, bs, nvar, nt, nx, ny, res.k, *cell[1:], float(np.float32(eps)),
                _build.stream_of(truth))
    _build.check(lib, rc, what)
    _joint_cp_scores_single_pass.launches += 1
    return bits[::_SCORE_STRIDE].contiguous().view(torch.float32)


_joint_cp_scores_single_pass.launches = 0


def _k9_grid(shape, res: _Residual):
    """K9's launch for [BS, Nvar, Nt, Nx, Ny] inputs and cell `res` on this
    card: route ('stash', or 'recompute' for a batch whose stash does not
    fit a block's shared memory), cells (a block's stash, 0 without one),
    blocks, threads (a block), smem (bytes) and lanes (threads a cell)."""
    lib = _build.library("stencil_kernels")
    fn = _build.declare(lib, "cppre_joint_cp_scores_single_pass_geom", [_I] * 7 + [_P])
    g = (ctypes.c_longlong * 5)()
    _build.check(lib, fn(res.kind, *shape, res.k, g), "K9 geometry")
    g = [int(v) for v in g]
    return dict(route="stash" if g[0] else "recompute", cells=g[0], blocks=g[1],
                threads=g[2], smem=g[3], lanes=g[4])


def _scores(truth, prediction, res, eps, samples_per_block, diff_dtype, single_pass, what):
    if single_pass:
        return _joint_cp_scores_single_pass(truth, prediction, res, eps, what)
    diff, _, _, m2 = _diff_stats_routed(truth, prediction, res, samples_per_block,
                                        diff_dtype, what, centred=True)
    return _scores_from_diff_stats(diff, m2, truth.shape[0], eps)


def _scores_plain(truth, prediction, res, eps, diff_dtype, what):
    _check_pair(truth, prediction, res, what)
    diff, _, _, m2 = _diff_stats_plain(truth, prediction, res, diff_dtype, centred=True)
    return _scores_from_diff_stats(diff, m2, truth.shape[0], eps)


def ns_joint_cp_scores_plain(truth, prediction, dt: float, dx: float, dy: float,
                             nu: float = 0.001, eps: float = 1e-6, diff_dtype=None):
    """Plain PyTorch `ns_joint_cp_scores_fused`."""
    return _scores_plain(truth, prediction, _ns_cell(dt, dx, dy, nu), eps, diff_dtype,
                         "ns_joint_cp_scores")


def ns_joint_cp_scores_fused(truth, prediction, dt: float, dx: float, dy: float,
                             nu: float = 0.001, eps: float = 1e-6,
                             samples_per_block: int = 1, diff_dtype=None,
                             single_pass: bool = False):
    """Joint-CP nonconformity scores [BS] over the NS momentum PRE:
    per-sample sup-norm of |diff| / (std(diff, axis=0) + eps), the same as
    `modulation_func` + `ncf_metric_joint`. Two-pass through kernel K1 (or
    K3, by `routing_decision`) and the epilogue; `single_pass=True` launches
    K9 instead (it stages no diff,
    so `diff_dtype` and `samples_per_block` do not apply)."""
    return _scores(truth, prediction, _ns_cell(dt, dx, dy, nu), eps, samples_per_block,
                   diff_dtype, single_pass, "ns_joint_cp_scores_fused")


def mhd_induction_joint_cp_scores_plain(truth, prediction, eps: float = 1e-6,
                                        diff_dtype=None):
    """Plain PyTorch `mhd_induction_joint_cp_scores_fused`."""
    return _scores_plain(truth, prediction, _mhd_cell("induction"), eps, diff_dtype,
                         "mhd_induction_joint_cp_scores")


def mhd_induction_joint_cp_scores_fused(truth, prediction, eps: float = 1e-6,
                                        samples_per_block: int = 1, diff_dtype=None,
                                        single_pass: bool = False):
    """Joint-CP nonconformity scores [BS] over the MHD induction PRE, one
    read of each [BS, 6, Nt, Nx, Ny] tensor per pass: K1 (or K3, by
    `routing_decision`) and the epilogue, or with `single_pass=True` kernel
    K9."""
    return _scores(truth, prediction, _mhd_cell("induction"), eps, samples_per_block,
                   diff_dtype, single_pass, "mhd_induction_joint_cp_scores_fused")


def wave_joint_cp_scores_plain(truth, prediction, kernel, eps: float = 1e-6,
                               diff_dtype=None):
    """Plain PyTorch `wave_joint_cp_scores_fused`."""
    return _scores_plain(truth[:, None], prediction[:, None], _taps_cell(kernel), eps,
                         diff_dtype, "wave_joint_cp_scores")


def wave_joint_cp_scores_fused(truth, prediction, kernel, eps: float = 1e-6,
                               samples_per_block: int = 1, diff_dtype=None):
    """Joint-CP nonconformity scores [BS] over the wave composite-kernel PRE
    through K1 (or, for k = 3, K3 by `routing_decision`) and the epilogue.
    truth/prediction [BS, Nt, Nx, Ny]
    single-variable trajectories; kernel the additive D_tt - (c dt/dx)^2
    D_xxyy stencil, or any [k, k, k] kernel with odd k (valid interior
    (Nt-k+1, Nx-k+1, Ny-k+1))."""
    return _scores(truth[:, None], prediction[:, None], _taps_cell(kernel), eps,
                   samples_per_block, diff_dtype, False, "wave_joint_cp_scores_fused")


def jorek_joint_cp_scores_plain(truth, prediction, R, Dc: float = 3.4, K: float = 2.25e-7,
                                equation: str = "continuity", eps: float = 1e-6,
                                diff_dtype=None):
    """Plain PyTorch `jorek_joint_cp_scores_fused`."""
    return _scores_plain(truth, prediction, _jorek_cell(R, Dc, K, equation), eps, diff_dtype,
                         "jorek_joint_cp_scores")


def jorek_joint_cp_scores_fused(truth, prediction, R, Dc: float = 3.4, K: float = 2.25e-7,
                                equation: str = "continuity", eps: float = 1e-6,
                                diff_dtype=None):
    """Joint-CP nonconformity scores [BS] over a JOREK reduced-MHD PRE, one
    read of each [BS, 3, Nt, NR, NZ] tensor: K1 (or K3, by
    `routing_decision`) and the epilogue. R is the 1-D major-radius grid;
    unlike cppre, a non-affine grid takes the kernel too."""
    return _scores(truth, prediction, _jorek_cell(R, Dc, K, equation), eps, 1, diff_dtype,
                   False, "jorek_joint_cp_scores_fused")
