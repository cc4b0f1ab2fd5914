"""Spatially split stencil convolution by halo exchange (port of
`cppre.parallel.halo`).

For fields too large for one device ([BS, Nt, Nx, Ny] with a large Nx),
split the x axis over a mesh axis, exchange k//2 ghost slabs with the two
neighbours along it (`batch_isend_irecv`), then run the shift-add stencil
(`ops.convops.stencil_shift_add`, plain torch on the card as it is XLA in
cppre) on each rank's extended block. The global edges get zero slabs, so
the result is `ConvOperator.convolution`'s SAME zero-pad correlation, bit
for bit: interior block boundaries read true neighbour data. A neighbour
beyond a global edge is sent nothing, which is cppre's ring with its
wrapped slabs zeroed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.convops import stencil_shift_add
from .sharding import Mesh, Sharded, _blocks

__all__ = ["stencil_conv_sharded", "stencil_conv_sharded_2d"]


def _check_halo(halo: int, size: int, ax: int):
    if halo > size:
        raise ValueError(
            f"stencil halo ({halo}) exceeds the local shard extent ({size}) "
            f"on axis {ax}: ring exchange only reaches immediate neighbours; "
            f"use fewer shards or a narrower kernel")


def _exchange_axis(block, halo: int, ax: int, mesh: Mesh, axis_name: str):
    """Extend `block` along `ax` with halo slabs from the two neighbours
    along `axis_name`; the global edges get zeros (SAME zero-pad)."""
    size = block.shape[ax]
    _check_halo(halo, size, ax)
    idx, n = mesh.index(axis_name), mesh.shape[axis_name]
    group = mesh.group(axis_name)
    lo = block.narrow(ax, 0, halo).contiguous()          # my first rows
    hi = block.narrow(ax, size - halo, halo).contiguous()
    # neighbour i-1's hi becomes my left ghost; i+1's lo my right ghost
    left, right = torch.zeros_like(lo), torch.zeros_like(hi)
    ops = []
    if halo and idx > 0:
        peer = dist.get_global_rank(group, idx - 1)
        ops += [dist.P2POp(dist.isend, lo, peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if halo and idx < n - 1:
        peer = dist.get_global_rank(group, idx + 1)
        ops += [dist.P2POp(dist.isend, hi, peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([left, block, right], dim=ax)


def _pad_rest(ext, kernel, split_axes):
    """SAME zero-pad every kernel dim (aligned to the field's last dims)
    that is not split: those are whole on every rank."""
    nd, ndim = kernel.ndim, ext.ndim
    pads = []
    for d in reversed(range(nd)):
        half = 0 if ndim - nd + d in split_axes else kernel.shape[d] // 2
        pads += [half, half]
    return F.pad(ext, pads)


def stencil_conv_sharded(field, kernel: np.ndarray, mesh: Mesh, axis: str = "sp",
                         spatial_axis: int = -2) -> Sharded:
    """Cross-correlate `field` with a constant stencil, `spatial_axis` split
    over mesh axis `axis` (it must divide evenly).

    field: [..., Nx, Ny], whole on every rank or a `Sharded` split the same
    way. Returns this rank's block of the SAME-padded correlation, which
    equals `direct_conv(field, kernel)` bit for bit (`full_tensor()`)."""
    kernel = np.asarray(kernel)
    part = _blocks(field, mesh, (axis,), (spatial_axis,), even=True)
    ax = part.dims[0]
    halo = kernel.shape[spatial_axis] // 2
    ext = _exchange_axis(part.local, halo, ax, mesh, axis)
    out = stencil_shift_add(_pad_rest(ext, kernel, (ax,)), kernel, same=False)
    return Sharded(out, mesh, part.axes, part.dims, part.sizes)


def stencil_conv_sharded_2d(field, kernel: np.ndarray, mesh: Mesh,
                            axes: tuple[str, str] = ("spx", "spy"),
                            spatial_axes: tuple[int, int] = (-2, -1)) -> Sharded:
    """(x, y) 2-D decomposition of the halo-exchange stencil: both spatial
    axes split over their own mesh axis. Exchanging the x halos FIRST and
    then the y halos OF THE X-EXTENDED block carries the corner ghosts
    along (the y slabs already hold the neighbours' x ghosts), so dense
    k x k stencils with diagonal taps are exact: equal to
    `direct_conv(field, kernel)` bit for bit."""
    kernel = np.asarray(kernel)
    part = _blocks(field, mesh, axes, spatial_axes, even=True)
    ax_x, ax_y = part.dims
    nd, ndim = kernel.ndim, part.local.ndim
    # kernel dims align to the LAST nd field axes
    halo_x = kernel.shape[nd - (ndim - ax_x)] // 2
    halo_y = kernel.shape[nd - (ndim - ax_y)] // 2
    ext = _exchange_axis(part.local, halo_x, ax_x, mesh, axes[0])
    ext = _exchange_axis(ext, halo_y, ax_y, mesh, axes[1])
    out = stencil_shift_add(_pad_rest(ext, kernel, (ax_x, ax_y)), kernel, same=False)
    return Sharded(out, mesh, part.axes, part.dims, part.sizes)
