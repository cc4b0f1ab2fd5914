"""Pipeline-parallel FNO forward: the 6 Fourier blocks as GPipe stages
(port of `cppre.parallel.pipeline`).

Each 'pp' rank runs 6/pp consecutive blocks of `model.blocks()`;
microbatches hop rank to rank. Tick t: rank 0 takes in microbatch t (while
t < n_micro), every rank runs its blocks on the state it holds, and the
state moves one rank on. The last rank finishes microbatch m at tick
m + pp - 1; its rows are summed over 'pp' (the other ranks add zeros), so
every rank holds the output. The lift and the head stay outside the
pipeline, computed where they are used with the model's own layers, so
they run under the caller's precision scope (`models.precision_scope`)
as `model(x)` does. The blocks run the module's plain forward, as cppre's
pipeline runs flax's.

Stage state is the pair (x, skip) stacked in one tensor: the reference's
skip pattern (x0 = f0(x); f2(f1(x0)) + x0, repeated for f3..f5) sets the
skip at global block g % 3 == 0 and consumes it at g % 3 == 2, so for
pp = 3 or 6 it rides the same hop as x.

Differentiable end to end, in the input and in each rank's own blocks and
head. Point-to-point sends carry no autograd in torch, so the hop is an
`autograd.Function` whose backward is the reverse hop; the final sum's
backward passes the gradient through unchanged, the split of the input over
'dp' gathers the input gradient, and the entry to the pipeline sums it over
'pp' (only rank 0 ingests): every rank gets the gradient of the one global
loss each computes. Every rank takes part in every hop's backward (the
states a rank drops still enter its graph, times zero), so the ranks'
collectives pair up.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .sharding import Mesh, _block, _gather, _sum

__all__ = ["make_pp_fno_apply", "pp_supported"]

_N_BLOCKS = 6  # FNO_multi2d depth


def pp_supported(mesh: Mesh, axis: str = "pp") -> bool:
    """True when the mesh's `axis` extent divides the 6-block stack."""
    return axis in mesh.shape and _N_BLOCKS % mesh.shape[axis] == 0


def _hop(t, mesh: Mesh, axis: str, shift: int):
    """Send `t` `shift` ranks on along `axis` (a ring); return what arrives."""
    n = mesh.shape[axis]
    if n == 1:
        return t.clone()
    idx, group = mesh.index(axis), mesh.group(axis)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, (idx + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (idx - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingHop(torch.autograd.Function):
    """Forward: the state moves one rank on; backward: its gradient moves
    one rank back."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _hop(t, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, ctx.mesh, ctx.axis, -1), None, None


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over `axis`; every rank then holds the output and
    computes the same loss, so the backward passes each rank's gradient
    through unchanged."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterPipeline(torch.autograd.Function):
    """Forward: identity (every rank holds the input); backward: the sum
    over `axis` of the ranks' gradients (only rank 0 feeds the pipeline)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _SplitRows(torch.autograd.Function):
    """Forward: this rank's block of rows (of a batch whole on every rank
    and a multiple of the axis' extent); backward: the blocks' gradients
    gathered, so every rank holds the whole input gradient."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        lo, hi = _block(t.shape[0], mesh.shape[axis], mesh.index(axis))
        return t[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g.contiguous(), ctx.mesh, ctx.axis)), None, None


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows along `axis`, in rank order; backward: the
    gradient of this rank's rows (each rank computes the same loss)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, t.shape[0]
        return torch.cat(_gather(t, mesh, axis))

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


def _through(fn, t, mesh, axis):
    return fn.apply(t, mesh, axis) if axis is not None else t


def make_pp_fno_apply(model, mesh: Mesh, axis: str = "pp", dp_axis: str | None = None,
                      n_microbatches: int | None = None):
    """Pipeline-parallel `model(x)` for an FNO2d over mesh axis `axis`.

    `mesh.shape[axis]` must divide 6 (1, 2, 3 or 6 stages). With `dp_axis`
    the batch is also split over it (a 2-D ('dp', 'pp') mesh). The input is
    whole on every rank; batches are
    zero-padded to a multiple of dp * n_micro and the output cropped, and
    it comes back whole on every rank. Deterministic forward only (dropout
    off: the inference and calibration path)."""
    pp = mesh.shape[axis]
    if _N_BLOCKS % pp != 0:
        raise ValueError(f"'{axis}' extent ({pp}) must divide {_N_BLOCKS} blocks")
    if model.dropout_rate > 0.0:
        raise ValueError("make_pp_fno_apply runs the deterministic forward; the model has "
                         f"dropout_rate={model.dropout_rate}")
    bps = _N_BLOCKS // pp
    dp = mesh.shape[dp_axis] if dp_axis else 1
    n_micro = n_microbatches or pp
    d = mesh.index(axis)
    blocks = model.blocks()[d * bps:(d + 1) * bps]

    def run_blocks(state, grid_c):
        x, skip = state[0], state[1]
        for j, blk in enumerate(blocks):
            y = blk(x, grid_c)
            g = d * bps + j
            if g % 3 == 0:          # set the skip
                x, skip = y, y
            elif g % 3 == 1:        # pass it through
                x = y
            else:                   # consume it
                x = y + skip
        return torch.stack((x, skip))

    def apply_fn(x):
        x = torch.as_tensor(x, device=mesh.device)
        n = x.shape[0]
        pad = (-n) % (dp * n_micro)
        if pad:
            x = torch.cat((x, x.new_zeros((pad,) + tuple(x.shape[1:]))))
        x = _through(_EnterPipeline, x, mesh, axis)
        x = _through(_SplitRows, x, mesh, dp_axis)
        grid = model.get_grid(x.shape, x.device).to(x.dtype)
        h = model.fc0_time(torch.cat((x, grid), dim=-1)).permute(0, 4, 1, 2, 3)
        grid_c = grid[:1].permute(0, 4, 1, 2, 3)
        mb = h.shape[0] // n_micro
        state = h.new_zeros((2, mb) + tuple(h.shape[1:]))
        outs = []
        # Every hop, and the lift, must reach each rank's loss, or a rank
        # would skip a collective in the backward that the others run: so
        # the states a rank drops enter its graph times zero.
        for t in range(n_micro + pp - 1):
            if d == 0 and t < n_micro:
                x_in = h[t * mb:(t + 1) * mb]
                state = torch.stack((x_in, torch.zeros_like(x_in))) + 0.0 * state
            elif t == 0:
                state = state + 0.0 * h[:mb]
            state = run_blocks(state, grid_c)
            if d == pp - 1 and t >= pp - 1:
                outs.append(state[0])
            if t < n_micro + pp - 2:
                state = _RingHop.apply(state, mesh, axis)
        # only the last rank's rows are real; the others add zeros
        z = torch.cat(outs) if outs else (0.0 * state[0]).repeat(n_micro, 1, 1, 1, 1)
        z = _SumReplicated.apply(z, mesh, axis)
        z = z.permute(0, 2, 3, 4, 1)
        out = model.fc2_time(F.gelu(model.fc1_time(z)))
        out = _through(_GatherRows, out, mesh, dp_axis)
        return out[:n]

    return apply_fn
