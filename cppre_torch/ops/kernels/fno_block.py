"""FNO2d kernels: the Fourier block (K4) and the projection head (K5), and
their backward passes (K6, K7).

Port of `cppre/ops/pallas/fno_block.py`. Each kernel has a plain PyTorch
version of the same math beside it:

* `fno_block2d_fused` (CUDA `csrc/fno_block.cu`) / `fno_block2d_plain`:
  one Fourier block, gelu(mlp(spectral(x)) + w(x) + x3), with the spectral
  convolution as truncated DFTs against `_dft_tables`. x [B, W, V, Nx, Ny]
  float32 -> same shape; x3 the batch-constant bias branch [1, W, V, Nx, Ny].
* `projection2d_fused` / `projection2d_plain`: fc1 -> exact gelu -> fc2 per
  pixel, z [B, V, Nx, Ny, W] -> [B, V, Nx, Ny, step].
* `fno_block2d_bwd_fused` (CUDA `csrc/fno_block_bwd.cu`) /
  `fno_block2d_bwd_plain`: the block's backward from its input x and the
  output cotangent g: dx, the spectral grads in the repacked
  [in, out, V, m2, K] layout, the channel-map grads and dx3, the weight
  grads summed over batch and variables.
* `projection2d_bwd_fused` / `projection2d_bwd_plain`: the head's backward,
  dz and the fc1/fc2 grads summed over every pixel.

Weights come from the port's modules (`cppre_torch.models.fno`): a block is
an `_FNOBlock2d`, the head two `_Linear`s. The kernels run at the true Nx
and Ny; the JAX package's x padding to 8 rows and flattened head output
were TPU layout needs and are gone. Gradients of a [out, in] channel map
come back in that layout (the port's), biases as [n].

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each kernel wrapper counts its launches in `.launches`
(one per block or head call).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "fno_block2d_fused",
    "fno_block2d_plain",
    "fno_block2d_bwd_fused",
    "fno_block2d_bwd_plain",
    "projection2d_fused",
    "projection2d_plain",
    "projection2d_bwd_fused",
    "projection2d_bwd_plain",
    "fno_kernel_limits",
]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# What the CUDA kernels are compiled for (csrc/fno_block*.cu): the channel
# widths of the register-resident stages, the head's widest output step, and
# the shared memory of one block.
KERNEL_WIDTHS = (4, 8, 16, 32)
KERNEL_MAX_STEP = 10
_SMEM_LIMIT = 227 * 1024


# The shapes of the pixel-tile stages (csrc/fno_tile.cuh) and of the
# forward-DFT stage (csrc/fno_dft.cuh), for the shared-memory limits.
_TILE_P, _TILE_LD, _TILE_ROWS = 128, 132, 4
_DFT_ROWS, _DFT_MAX_PLANES, _DFT_PLANE_FLOATS, _DFT_THREADS = 128, 8, 16384, 128


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _dft_smem(nx: int, ny: int, m2: int, k_fr: int) -> int:
    """Shared memory (bytes) of the forward-DFT stage (csrc/fno_dft.cuh,
    dft_geom and dft_floats) at its most planes a block, G (up to 128 rows,
    8 planes and 16384 floats, at least one plane; small batches take
    fewer), transposed
    [Ny, rows + 4] (or, if larger, the partial sums of the x product's S
    row slices, which take their room), the x tables [Nx, 2*Kp] and the y
    products [rows, 2*m2p]."""
    g = max(1, min(_DFT_MAX_PLANES, _DFT_ROWS // nx, _DFT_PLANE_FLOATS // (nx * ny)))
    rows = _round4(g * nx)
    per_plane = (_round4(m2) // 4) * (_round4(k_fr) // 4)
    s = max(1, min(8, _DFT_THREADS // per_plane))
    part = s * g * per_plane * 32 if s > 1 else 0
    return 4 * (max(ny * (rows + 4), part) + nx * 2 * _round4(k_fr) + rows * 2 * _round4(m2))


def _tile_geom(nx: int, ny: int) -> tuple[int, int]:
    """(ty, rt) of the pixel tiles of K4's and K6's stages
    (csrc/fno_tile.cuh, tile_geom): a tile is rt rows of ty y positions."""
    nseg = -(-ny // _TILE_P)
    ty = _round4(-(-ny // nseg))
    return ty, min(_TILE_P // ty, _TILE_ROWS, nx)


def _tile_smem(width: int, nx: int, ny: int, m2: int, backward: bool) -> int:
    """Shared memory (bytes) of K4's output stage (csrc/fno_block.cu,
    launch_block_out) or, with `backward`, of K6's largest stage, its
    stage 2 (csrc/fno_block_bwd.cu, launch_bwd_tiles): [W, 132]-float
    pixel tiles (4 for K4, 8 for K6), the W x W maps (3, 5) and biases, two
    buffers of the tile rows' inverse-x values [rt, 2*m2, W] and the y
    tables' slice [2*m2, ty]."""
    ty, rt = _tile_geom(nx, ny)
    spec = 2 * rt * 2 * m2 * width + 2 * m2 * ty
    tiles, maps = (8, 5) if backward else (4, 3)
    return 4 * (tiles * width * _TILE_LD + maps * width * width + 3 * width + spec)


def fno_kernel_limits(width: int, step: int, nx: int, ny: int, m1: int, m2: int,
                      backward: bool = False) -> list[str]:
    """The limits of kernels K4 and K5 (with `backward`, also K6 and K7)
    that this configuration breaks, in words; empty when they take it. The
    limits: a compiled width, 1 <= step <= 10, the modes within the one-sided
    spectrum (2*m1 <= Nx, m2 <= Ny//2+1), and the forward-DFT stage's planes,
    the inverse-x stage's tables and the pixel-tile stage (K4's or K6's)
    each within one block's shared memory."""
    broken = []
    if width not in KERNEL_WIDTHS:
        broken.append(f"width {width} is not one of the compiled widths {KERNEL_WIDTHS}")
    if not 1 <= step <= KERNEL_MAX_STEP:
        broken.append(f"step {step} is outside 1..{KERNEL_MAX_STEP}")
    if not (2 * m1 <= nx and m2 <= ny // 2 + 1):
        broken.append(f"modes ({m1}, {m2}) exceed the {nx}x{ny} grid's one-sided spectrum")
    plane = _dft_smem(nx, ny, m2, 2 * m1)
    if plane > _SMEM_LIMIT:
        broken.append(f"the forward-DFT stage needs {plane} B of shared memory for a {nx}x{ny} "
                      f"plane, above {_SMEM_LIMIT} B")
    inv_x = 4 * 2 * (2 * m1) * (_round4(nx) + _TILE_LD)
    if inv_x > _SMEM_LIMIT:
        broken.append(f"the inverse-x stage needs {inv_x} B of shared memory for Nx {nx} and "
                      f"{2 * m1} x-modes, above {_SMEM_LIMIT} B")
    row = _tile_smem(width, nx, ny, m2, backward)
    if row > _SMEM_LIMIT:
        broken.append(f"{'K6' if backward else 'K4'}'s tile stage needs {row} B of shared "
                      f"memory at width {width}, Ny {ny}, m2 {m2}, above {_SMEM_LIMIT} B")
    return broken


@functools.lru_cache(maxsize=16)
def _dft_tables(nx: int, ny: int, m1: int, m2: int, device=None):
    """The eight transform tables, built in float64 and stored in float32
    exactly as `cppre.ops.pallas.fno_block._dft_tables` builds them:
    (cy, sy) [Ny, m2], (cx, sx) [Nx, K], (cxT, sxT) [K, Nx], and the
    inverse-y tables (iyc, iys) [m2, Ny] with the Hermitian weights folded
    in (1 for k=0 and, for even Ny with m2 == Ny//2+1, the Nyquist bin)."""
    freqs = list(range(m1)) + list(range(nx - m1, nx))
    ang_y = -2.0 * np.pi * np.outer(np.arange(ny), np.arange(m2)) / ny
    cy, sy = np.cos(ang_y), np.sin(ang_y)
    ang_x = -2.0 * np.pi * np.outer(np.arange(nx), freqs) / nx
    cx, sx = np.cos(ang_x), np.sin(ang_x)
    w = np.full(m2, 2.0)
    w[0] = 1.0
    if ny % 2 == 0 and m2 == ny // 2 + 1:
        w[-1] = 1.0
    iyc, iys = w[:, None] * cy.T, w[:, None] * sy.T
    return tuple(torch.tensor(np.ascontiguousarray(t), dtype=torch.float32, device=device)
                 for t in (cy, sy, cx, sx, cx.T, sx.T, iyc, iys))


@functools.lru_cache(maxsize=16)
def _adjoint_tables(nx: int, ny: int, m1: int, m2: int, device=None):
    """The transposed forward-y tables (cy^T, sy^T) [m2, Ny]: the adjoint
    of the forward y transform, which K6's last stage applies."""
    cy, sy = _dft_tables(nx, ny, m1, m2, device)[:2]
    return cy.T.contiguous(), sy.T.contiguous()


@functools.lru_cache(maxsize=16)
def _dft_y_packed(nx: int, ny: int, m1: int, m2: int, device=None):
    """The y tables of the forward-DFT stage (csrc/fno_dft.cuh,
    dft_fwd_kernel), each packed [Ny, 2*m2p] with m2p = m2 rounded up to 4
    and zero columns between: [cy | sy] for the forward transform and
    [iyc^T | iys^T] for K6's adjoint of the inverse one."""
    cy, sy, _, _, _, _, iyc, iys = _dft_tables(nx, ny, m1, m2, device)
    m2p = _round4(m2)

    def pack(c, s):
        out = torch.zeros((ny, 2 * m2p), dtype=torch.float32, device=device)
        out[:, :m2], out[:, m2p:m2p + m2] = c, s
        return out

    return pack(cy, sy), pack(iyc.T, iys.T)


def _repack_spectral(conv, m1: int, m2: int):
    """The block's two complex [in, out, V, m1, m2] weights -> real and
    imaginary [in, out, V, m2, K] (K = 2*m1, low modes then high), the
    kernel's frequency order."""
    w = torch.cat([conv.weights1, conv.weights2], dim=3).transpose(3, 4)
    return w.real.contiguous(), w.imag.contiguous()


def _unpack_spectral(dwr, dwi, m1: int):
    """The inverse of `_repack_spectral` for gradients: real and imaginary
    [in, out, V, m2, K] -> the two complex [in, out, V, m1, m2] gradients
    (d/dRe + i d/dIm, torch's convention for a real loss)."""
    d = torch.complex(dwr, dwi).transpose(3, 4)
    return d[:, :, :, :m1].contiguous(), d[:, :, :, m1:].contiguous()


def _mat(lin):
    """A 1x1 channel map's weight as [out, in] (a view)."""
    return lin.weight.reshape(lin.weight.shape[0], lin.weight.shape[1])


def _block_tensors(block, m1: int, m2: int):
    wr, wi = _repack_spectral(block.conv, m1, m2)
    return dict(wr=wr, wi=wi,
                a1=_mat(block.mlp.mlp1), b1=block.mlp.mlp1.bias,
                a2=_mat(block.mlp.mlp2), b2=block.mlp.mlp2.bias,
                aw=_mat(block.w), bw=block.w.bias)


def _channel(x, a, b):
    """[B, Cin, ...] -> [B, Cout, ...]: b[o] + sum_i a[o, i] x[:, i]."""
    return torch.movedim(F.linear(torch.movedim(x, 1, -1), a, b), -1, 1)


# ---- K4 ---------------------------------------------------------------------

def fno_block2d_plain(x, block, x3, m1: int, m2: int):
    """Plain PyTorch Fourier block: the truncated DFT y then x, the
    per-mode complex channel mix, the inverse x then y transform, the
    channel MLP with exact gelu, the 1x1 bypass, the bias branch x3 and
    the final gelu."""
    return _block_math(x, x3, _block_tensors(block, m1, m2), m1, m2)


def _block_math(x, x3, t, m1: int, m2: int):
    """`fno_block2d_plain` on the block's tensors `t` (`_block_tensors`)."""
    nx, ny = x.shape[-2], x.shape[-1]
    cy, sy, cx, sx, cxT, sxT, iyc, iys = _dft_tables(nx, ny, m1, m2, x.device)
    yr, yi = x @ cy, x @ sy                                          # [B, W, V, Nx, m2]
    zr = (torch.einsum("bcvxm,xk->bcvmk", yr, cx) - torch.einsum("bcvxm,xk->bcvmk", yi, sx))
    zi = (torch.einsum("bcvxm,xk->bcvmk", yr, sx) + torch.einsum("bcvxm,xk->bcvmk", yi, cx))
    eq = "bivmk,iovmk->bovmk"
    mr = torch.einsum(eq, zr, t["wr"]) - torch.einsum(eq, zi, t["wi"])
    mi = torch.einsum(eq, zr, t["wi"]) + torch.einsum(eq, zi, t["wr"])
    vr = mr @ cxT + mi @ sxT                                          # [B, W, V, m2, Nx]
    vi = mi @ cxT - mr @ sxT
    spec = (vr.transpose(-1, -2) @ iyc + vi.transpose(-1, -2) @ iys) * (1.0 / (nx * ny))
    h = F.gelu(_channel(spec, t["a1"], t["b1"]))
    x1 = _channel(h, t["a2"], t["b2"])
    x2 = _channel(x, t["aw"], t["bw"])
    return F.gelu(x1 + x2 + x3)


def fno_block2d_fused(x, block, x3, m1: int, m2: int):
    """One Fourier block (kernel K4). x [B, W, V, Nx, Ny] float32; `block` an
    `_FNOBlock2d` of the port (its `.b` bias branch is not read: the caller
    passes it precomputed as x3 [1, W, V, Nx, Ny]). Returns [B, W, V, Nx, Ny].

    Needs 2*m1 <= Nx and m2 <= Ny//2+1; on CUDA also a width the kernel is
    compiled for (`fno_kernel_limits`)."""
    if x.ndim != 5:
        raise ValueError(f"fno_block2d_fused: expected x [B, W, V, Nx, Ny], got {tuple(x.shape)}")
    b, w_ch, nv, nx, ny = x.shape
    if not (2 * m1 <= nx and m2 <= ny // 2 + 1):
        raise ValueError(f"modes ({m1}, {m2}) exceed the {nx}x{ny} grid's one-sided spectrum")
    if not _build.on_cuda(x):
        return fno_block2d_plain(x, block, x3, m1, m2)
    if w_ch not in KERNEL_WIDTHS:
        raise ValueError(f"fno_block2d_fused: width {w_ch} not in {KERNEL_WIDTHS}")
    dev = x.device
    _build.require(x, "x")
    _build.require(x3, "x3", (1, w_ch, nv, nx, ny), device=dev)
    t = {k: v.detach().contiguous() for k, v in _block_tensors(block, m1, m2).items()}
    for k, v in t.items():
        _build.require(v, f"block weight {k}", device=dev)
    if t["a1"].shape != (w_ch, w_ch) or t["wr"].shape != (w_ch, w_ch, nv, m2, 2 * m1):
        raise ValueError("block weights do not match the input's width, variables or modes")
    _, _, cx, sx, cxT, sxT, iyc, iys = _dft_tables(nx, ny, m1, m2, dev)
    tables = (_dft_y_packed(nx, ny, m1, m2, dev)[0], cx, sx, cxT, sxT, iyc, iys)
    k_fr = 2 * m1
    # one allocation: vx [B, V, Nx, 2*m2, W] first (the kernel reads it as
    # float4), then z and m, re and im, [B, V, W, m2, K] each
    n_vx, n_spec = b * nv * nx * 2 * m2 * w_ch, b * nv * w_ch * m2 * k_fr
    buf = torch.empty(n_vx + 4 * n_spec, device=dev, dtype=torch.float32)
    vx, spec = buf[:n_vx], buf[n_vx:]
    scratch = [spec[i * n_spec:(i + 1) * n_spec] for i in range(4)] + [vx]
    out = torch.empty_like(x)
    lib = _build.library("fno_block")
    fn = _build.declare(lib, "cppre_fno_block2d_fwd", [_P] * 23 + [_I] * 7 + [_F, _P])
    ptrs = [x, x3, t["wr"], t["wi"], t["a1"], t["b1"], t["a2"], t["b2"], t["aw"], t["bw"],
            *tables, *scratch, out]
    with torch.cuda.device(dev):
        rc = fn(*(p.data_ptr() for p in ptrs), b, w_ch, nv, nx, ny, m2, k_fr,
                1.0 / (nx * ny), _build.stream_of(x))
    _build.check(lib, rc, "fno_block2d_fused")
    fno_block2d_fused.launches += 1
    return out


fno_block2d_fused.launches = 0


# ---- K6 ---------------------------------------------------------------------

_GRAD_ORDER = ("wr", "wi", "a1", "b1", "a2", "b2", "aw", "bw")


def fno_block2d_bwd_plain(x, g, block, x3, m1: int, m2: int):
    """Plain PyTorch backward of the Fourier block: autograd of
    `fno_block2d_plain` with respect to x, the repacked spectral weights,
    the six channel-map tensors and x3, for the output cotangent g. The
    same tuple and layout as `fno_block2d_bwd_fused`."""
    t = {k: v.detach().requires_grad_() for k, v in _block_tensors(block, m1, m2).items()}
    xs, x3s = x.detach().requires_grad_(), x3.detach().requires_grad_()
    with torch.enable_grad():
        out = _block_math(xs, x3s, t, m1, m2)
        return torch.autograd.grad(out, [xs, *(t[k] for k in _GRAD_ORDER), x3s], g)


@functools.lru_cache(maxsize=64)
def _bwd_blocks(b: int, w_ch: int, nv: int, nx: int, ny: int) -> int:
    """Rows of K6's partial-sum scratch at this shape: its stage 2's fixed
    grid (csrc/fno_block_bwd.cu, cppre_fno_block2d_bwd_blocks)."""
    lib = _build.library("fno_block_bwd")
    return _build.declare(lib, "cppre_fno_block2d_bwd_blocks", [_I] * 5, _LL)(
        b, w_ch, nv, nx, ny)


def fno_block2d_bwd_fused(x, g, block, x3, m1: int, m2: int):
    """Backward of one Fourier block (kernel K6). x is the block's input and
    g the cotangent of its output, both [B, W, V, Nx, Ny] float32; block
    and x3 as for `fno_block2d_fused`. Returns

        (dx, dwr, dwi, da1, db1, da2, db2, daw, dbw, dx3)

    dx like x; dwr/dwi [in, out, V, m2, K] (`_repack_spectral`'s layout;
    `_unpack_spectral` maps them back); da1, da2, daw [out, in]; db1, db2,
    dbw [W]; dx3 [1, W, V, Nx, Ny], summed over the batch. On CUDA every sum
    is taken in a fixed order: two calls give equal bits."""
    if x.ndim != 5 or g.shape != x.shape:
        raise ValueError(f"fno_block2d_bwd_fused: expected x and g [B, W, V, Nx, Ny], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    b, w_ch, nv, nx, ny = x.shape
    if not (2 * m1 <= nx and m2 <= ny // 2 + 1):
        raise ValueError(f"modes ({m1}, {m2}) exceed the {nx}x{ny} grid's one-sided spectrum")
    if not _build.on_cuda(x):
        return fno_block2d_bwd_plain(x, g, block, x3, m1, m2)
    if w_ch not in KERNEL_WIDTHS:
        raise ValueError(f"fno_block2d_bwd_fused: width {w_ch} not in {KERNEL_WIDTHS}")
    dev = x.device
    _build.require(x, "x")
    _build.require(g, "g", x.shape, device=dev)
    _build.require(x3, "x3", (1, w_ch, nv, nx, ny), device=dev)
    t = {k: v.detach().contiguous() for k, v in _block_tensors(block, m1, m2).items()}
    for k, v in t.items():
        _build.require(v, f"block weight {k}", device=dev)
    if t["a1"].shape != (w_ch, w_ch) or t["wr"].shape != (w_ch, w_ch, nv, m2, 2 * m1):
        raise ValueError("block weights do not match the input's width, variables or modes")
    k_fr = 2 * m1
    n_part = 3 * w_ch * w_ch + 2 * w_ch
    f32 = dict(device=dev, dtype=torch.float32)
    lib = _build.library("fno_block_bwd")
    n_blocks = _bwd_blocks(b, w_ch, nv, nx, ny)
    # one scratch allocation: vx [B, V, Nx, 2*m2, W] first (the kernels read
    # it as float4), the 8 spectral planes, gs, dspec and the partial rows
    n_vx, n_work = b * nv * nx * 2 * m2 * w_ch, 8 * b * nv * w_ch * m2 * k_fr
    n_x = x.numel()
    buf = torch.empty(n_vx + n_work + 2 * n_x + n_blocks * n_part, **f32)
    vx, work = buf[:n_vx], buf[n_vx:n_vx + n_work]
    gs = buf[n_vx + n_work:n_vx + n_work + n_x]
    dspec = buf[n_vx + n_work + n_x:n_vx + n_work + 2 * n_x]
    partial = buf[n_vx + n_work + 2 * n_x:]
    dx = torch.empty_like(x)
    dwr = torch.empty((w_ch, w_ch, nv, m2, k_fr), **f32)
    dwi = torch.empty_like(dwr)
    red = torch.empty(n_part, **f32)
    dx3 = torch.empty((1, w_ch, nv, nx, ny), **f32)
    _, _, cx, sx, cxT, sxT, iyc, iys = _dft_tables(nx, ny, m1, m2, dev)
    ty, ty_adj = _dft_y_packed(nx, ny, m1, m2, dev)
    cyT, syT = _adjoint_tables(nx, ny, m1, m2, dev)
    fn = _build.declare(lib, "cppre_fno_block2d_bwd", [_P] * 31 + [_I] * 7 + [_F, _P])
    ptrs = [x, g, x3, t["wr"], t["wi"], t["a1"], t["b1"], t["a2"], t["b2"], t["aw"], t["bw"],
            ty, cx, sx, cxT, sxT, iyc, iys, ty_adj, cyT, syT,
            work, vx, gs, dspec, partial, dx, dwr, dwi, red, dx3]
    with torch.cuda.device(dev):
        rc = fn(*(p.data_ptr() for p in ptrs), b, w_ch, nv, nx, ny, m2, k_fr,
                1.0 / (nx * ny), _build.stream_of(x))
    _build.check(lib, rc, "fno_block2d_bwd_fused")
    fno_block2d_bwd_fused.launches += 1
    ww = w_ch * w_ch
    da1, da2, daw = (red[i * ww:(i + 1) * ww].view(w_ch, w_ch) for i in range(3))
    db1, db2 = red[3 * ww:3 * ww + w_ch], red[3 * ww + w_ch:]
    return dx, dwr, dwi, da1, db1, da2, db2, daw, db2.clone(), dx3


fno_block2d_bwd_fused.launches = 0


# ---- K5 ---------------------------------------------------------------------

def projection2d_plain(z, fc1, fc2):
    """Plain PyTorch projection head fc2(gelu(fc1(z))); materialises the
    [..., 256] hidden activation."""
    return F.linear(F.gelu(F.linear(z, fc1.weight, fc1.bias)), fc2.weight, fc2.bias)


def projection2d_fused(z, fc1, fc2):
    """Projection head (kernel K5): z [B, V, Nx, Ny, W] -> [B, V, Nx, Ny, step],
    fc1/fc2 the model's `fc1_time`/`fc2_time` (weights [Wp, W], [step, Wp]).
    The hidden activation stays on chip."""
    if z.ndim != 5:
        raise ValueError(f"projection2d_fused: expected z [B, V, Nx, Ny, W], got {tuple(z.shape)}")
    if not _build.on_cuda(z):
        return projection2d_plain(z, fc1, fc2)
    w_ch = z.shape[-1]
    w_proj, step = fc1.weight.shape[0], fc2.weight.shape[0]
    if w_ch not in KERNEL_WIDTHS or not 1 <= step <= KERNEL_MAX_STEP:
        raise ValueError(f"projection2d_fused: width {w_ch} / step {step} not compiled "
                         f"(widths {KERNEL_WIDTHS}, step <= {KERNEL_MAX_STEP})")
    dev = z.device
    _build.require(z, "z")
    ws = [p.detach().contiguous() for p in (fc1.weight, fc1.bias, fc2.weight, fc2.bias)]
    for name, p, shape in zip(("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"), ws,
                              ((w_proj, w_ch), (w_proj,), (step, w_proj), (step,))):
        _build.require(p, name, shape, device=dev)
    out = torch.empty(z.shape[:-1] + (step,), device=dev, dtype=torch.float32)
    lib = _build.library("fno_block")
    fn = _build.declare(lib, "cppre_projection2d_fwd", [_P] * 6 + [_LL, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        rc = fn(z.data_ptr(), *(p.data_ptr() for p in ws), out.data_ptr(),
                z.numel() // w_ch, w_ch, w_proj, step, _build.stream_of(z))
    _build.check(lib, rc, "projection2d_fused")
    projection2d_fused.launches += 1
    return out


projection2d_fused.launches = 0


# ---- K7 ---------------------------------------------------------------------

def projection2d_bwd_plain(z, g, fc1, fc2):
    """Plain PyTorch backward of the projection head: autograd of
    `projection2d_plain`. Returns (dz, da1, db1, da2, db2) as
    `projection2d_bwd_fused` does."""
    ws = [p.detach().requires_grad_() for p in (fc1.weight, fc1.bias, fc2.weight, fc2.bias)]
    zs = z.detach().requires_grad_()
    with torch.enable_grad():
        out = F.linear(F.gelu(F.linear(zs, ws[0], ws[1])), ws[2], ws[3])
        return torch.autograd.grad(out, [zs, *ws], g)


def projection2d_bwd_fused(z, g, fc1, fc2):
    """Backward of the projection head (kernel K7): z [B, V, Nx, Ny, W] the
    head's input, g [B, V, Nx, Ny, step] the cotangent of its output.
    Returns (dz, da1 [Wp, W], db1 [Wp], da2 [step, Wp], db2 [step]), the
    weight grads summed over every pixel in a fixed order. The [.., Wp]
    hidden activation stays on chip."""
    if z.ndim != 5:
        raise ValueError(f"projection2d_bwd_fused: expected z [B, V, Nx, Ny, W], "
                         f"got {tuple(z.shape)}")
    if not _build.on_cuda(z):
        return projection2d_bwd_plain(z, g, fc1, fc2)
    w_ch = z.shape[-1]
    w_proj, step = fc1.weight.shape[0], fc2.weight.shape[0]
    if w_ch not in KERNEL_WIDTHS or not 1 <= step <= KERNEL_MAX_STEP or not 1 <= w_proj <= 1024:
        raise ValueError(f"projection2d_bwd_fused: width {w_ch} / step {step} / hidden "
                         f"{w_proj} not compiled (widths {KERNEL_WIDTHS}, "
                         f"step <= {KERNEL_MAX_STEP}, hidden <= 1024)")
    dev = z.device
    _build.require(z, "z")
    _build.require(g, "g", z.shape[:-1] + (step,), device=dev)
    a1, b1, a2 = (p.detach().contiguous() for p in (fc1.weight, fc1.bias, fc2.weight))
    for name, p, shape in zip(("fc1.weight", "fc1.bias", "fc2.weight"), (a1, b1, a2),
                              ((w_proj, w_ch), (w_proj,), (step, w_proj))):
        _build.require(p, name, shape, device=dev)
    lib = _build.library("fno_block_bwd")
    n_blocks = _build.declare(lib, "cppre_projection2d_bwd_blocks", [])()
    n_part = w_proj * w_ch + w_proj + step * w_proj + step
    f32 = dict(device=dev, dtype=torch.float32)
    dz = torch.empty_like(z)
    partial = torch.empty((n_blocks, n_part), **f32)
    red = torch.empty(n_part, **f32)
    fn = _build.declare(lib, "cppre_projection2d_bwd", [_P] * 8 + [_LL, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        rc = fn(*(p.data_ptr() for p in (z, g, a1, b1, a2, dz, partial, red)),
                z.numel() // w_ch, w_ch, w_proj, step, _build.stream_of(z))
    _build.check(lib, rc, "projection2d_bwd_fused")
    projection2d_bwd_fused.launches += 1
    o1, o2 = w_proj * w_ch, w_proj * w_ch + w_proj
    return (dz, red[:o1].view(w_proj, w_ch), red[o1:o2],
            red[o2:o2 + step * w_proj].view(step, w_proj), red[o2 + step * w_proj:])


projection2d_bwd_fused.launches = 0
