"""Meshes, sharded batches and the data-parallel CP and training steps on
`torch.distributed` (port of `cppre.parallel.sharding`).

The JAX package is single-controller: one process drives every device, and
`jax.sharding` places global arrays. The port is SPMD: every rank runs the
same call (under `torchrun` or `torch.multiprocessing.spawn`, one rank a
card), holds its own block of each sharded value, and meets the others in
collectives. Every public function returns what cppre returns: gathered on
every rank, unless cppre returns it sharded; then it is a `Sharded`, this
rank's block, and `full_tensor()` gathers cppre's array.

* `Mesh` wraps a `torch.distributed.device_mesh.DeviceMesh` with named
  axes; `mesh.shape["dp"]` is an axis' extent, as in cppre.
* Blocks follow `torch.chunk` (and DTensor's `Shard(d)`): along a length n
  split over k ranks, rank i holds [i*c, min((i+1)*c, n)) with
  c = ceil(n / k), cppre's zero-pad-then-shard layout without the padding.
  A trailing rank may hold fewer rows, or none.
* Collectives gather and then fold in rank order, so every rank computes
  the same bits and a one-rank mesh gives exactly the single-device
  result; no float atomics enter a sum.

On the card a mesh is one rank over the one device (NCCL); ranks > 1 run
on the CPU under gloo (`device_type="cpu"`).
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "shard_batch",
    "map_batch",
    "fno_param_shardings",
    "sharded_calibrate",
    "sharded_fused_cp_scores",
    "make_sharded_train_step",
    "make_sharded_fused_apply",
]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


# ---- process group and mesh ------------------------------------------------

def _ensure_process_group(device_type: str):
    """Start a one-rank process group where none exists (`nccl` for cuda,
    `gloo` for cpu) over a FileStore in a temporary directory, so no port
    or environment variable is needed. An existing group is used as it is;
    one without `device_type`'s backend raises ValueError."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    backend = _BACKEND[device_type]
    if dist.is_initialized():
        have = str(dist.get_backend())
        if backend not in have:
            raise ValueError(f"the process group runs {have!r}; device_type={device_type!r} "
                             f"needs {backend!r}")
        return
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA device; on the CPU "
                           "pass device_type='cpu'")
    root = tempfile.mkdtemp(prefix="cppre_pg_")
    atexit.register(shutil.rmtree, root, True)
    # binding the card up front lets NCCL set its communicator up at once
    device_id = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
                 else None)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=device_id)
    atexit.register(lambda: dist.is_initialized() and dist.destroy_process_group())


class Mesh:
    """Named axes over a `DeviceMesh`: `shape` maps each axis name to its
    extent, `index(axis)` is this rank's coordinate on it, `group(axis)`
    the process group along it, and `device` this rank's device."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device_type = device_mesh.device_type
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.device_type == "cuda" else torch.device("cpu"))

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


@functools.lru_cache(maxsize=None)
def _mesh(device_type: str, shape: tuple, names: tuple) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=names))


def make_mesh(n_devices: int | None = None, dp: int | None = None, tp: int = 1,
              axis_names: Sequence[str] = ("dp", "tp"), device_type: str = "cuda") -> Mesh:
    """Mesh of shape (dp, tp) over the process group's ranks, which must
    number n_devices (default: all of them). Call it on every rank. Without
    a process group it starts a one-rank one (`_ensure_process_group`);
    meshes are kept per shape, names and device type."""
    _ensure_process_group(device_type)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices}, but the process "
                         f"group has {world}")
    if dp is None:
        dp = n_devices // tp
    if dp * tp != n_devices:
        raise ValueError(f"dp*tp must equal n_devices ({dp}*{tp} != {n_devices})")
    return _mesh(device_type, (dp, tp), tuple(axis_names))


# ---- blocks and collectives ------------------------------------------------

def _block(n: int, k: int, i: int) -> tuple[int, int]:
    """[lo, hi) of block i of a length n split over k ranks (torch.chunk)."""
    c = -(-n // k)
    lo = min(i * c, n)
    return lo, min(lo + c, n)


def _gather(t, mesh: Mesh, axis: str) -> list:
    """Every rank's `t` along `axis`, in rank order (all the same shape)."""
    t = t.contiguous()
    real = torch.view_as_real(t) if t.is_complex() else t
    parts = [torch.empty_like(real) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, real, group=mesh.group(axis))
    return [torch.view_as_complex(p) for p in parts] if t.is_complex() else parts


def _sum(t, mesh: Mesh, axis: str):
    """Sum of every rank's `t` along `axis`, folded in rank order, so each
    rank gets the same bits (a one-rank axis gives `t` itself)."""
    parts = _gather(t, mesh, axis)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _pad_to(t, dim: int, length: int, value=0.0):
    extra = length - t.shape[dim]
    if extra <= 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat((t, t.new_full(shape, value)), dim=dim)


class Sharded:
    """This rank's block of a tensor split along `dims` over mesh `axes`
    (one pair a split; torch.chunk blocks), of global extents `sizes`.
    `full_tensor()` gathers the whole tensor on every rank."""

    def __init__(self, local, mesh: Mesh, axes: Sequence[str], dims: Sequence[int],
                 sizes: Sequence[int]):
        self.local, self.mesh = local, mesh
        self.axes, self.sizes = tuple(axes), tuple(sizes)
        self.dims = tuple(d % local.ndim for d in dims)

    @property
    def shape(self):
        shape = list(self.local.shape)
        for d, n in zip(self.dims, self.sizes):
            shape[d] = n
        return torch.Size(shape)

    @property
    def dtype(self):
        return self.local.dtype

    def padded(self, value=0.0):
        """The block padded with `value` to the full block length of every
        split, the same shape on every rank."""
        out = self.local
        for ax, d, n in zip(self.axes, self.dims, self.sizes):
            out = _pad_to(out, d, -(-n // self.mesh.shape[ax]), value)
        return out

    def full_tensor(self):
        out = self.padded()
        for ax, d, n in reversed(tuple(zip(self.axes, self.dims, self.sizes))):
            out = torch.cat(_gather(out, self.mesh, ax), dim=d).narrow(d, 0, n)
        return out



def _blocks(x, mesh: Mesh, axes: Sequence[str], dims: Sequence[int],
            even: bool = False) -> Sharded:
    """`x` as this rank's block of a split along `dims` over `axes`: a
    `Sharded` split that way as it is, else (a whole tensor on every rank,
    or another split, gathered first) cut here. `even`: every split must
    divide evenly, as shard_map's do."""
    if isinstance(x, Sharded):
        if x.axes == tuple(axes) and x.dims == tuple(d % x.local.ndim for d in dims):
            return x
        x = x.full_tensor()
    x = torch.as_tensor(x, device=mesh.device)
    local = x
    for ax, d in zip(axes, dims):
        if even and x.shape[d] % mesh.shape[ax]:
            raise ValueError(f"axis {d} ({x.shape[d]}) must divide the mesh axis '{ax}' "
                             f"({mesh.shape[ax]})")
        lo, hi = _block(x.shape[d], mesh.shape[ax], mesh.index(ax))
        local = local.narrow(d, lo, hi - lo)
    return Sharded(local, mesh, axes, dims, [x.shape[d] for d in dims])


def shard_batch(x, mesh: Mesh, axis: str = "dp") -> Sharded:
    """The leading (batch) axis of `x`, whole on every rank, split over
    `axis`: this rank's rows as a `Sharded` (Shard(0))."""
    return _blocks(x, mesh, (axis,), (0,))


def map_batch(fn, mesh: Mesh, *xs, axis: str = "dp"):
    """fn over the batch of `xs` (whole tensors, or `Sharded` batches, of
    one batch length n), split over `axis`: each rank applies `fn` once to
    its rows zero-padded to the block length, and the outputs (a tensor or
    a tuple of them, batch-leading) come back gathered, cropped to n, on
    every rank. For per-sample maps such as rollouts: pad rows never touch
    real ones."""
    parts = [shard_batch(x, mesh, axis) for x in xs]
    n = parts[0].sizes[0]
    out = fn(*(p.padded() for p in parts))
    single = torch.is_tensor(out)
    lo, hi = _block(n, mesh.shape[axis], mesh.index(axis))
    outs = [Sharded(o[:hi - lo], mesh, (axis,), (0,), (n,)).full_tensor()
            for o in ((out,) if single else out)]
    return outs[0] if single else tuple(outs)


# ---- tensor-parallel layout -----------------------------------------------

def fno_param_shardings(model_or_state_dict, mesh: Mesh, axis: str = "tp",
                        overrides: dict | None = None, report: bool = False):
    """Tensor-parallel layout of an FNO's parameters: {name: placements}, one
    DTensor placement per mesh axis (`Shard(d)` on `axis`, `Replicate()`
    elsewhere), as `torch.distributed.tensor.distribute_tensor` takes them.

    The rule is cppre's, on the port's own layouts: every parameter with
    ndim >= 2 whose OUT-channel extent divides the axis shards its out
    dim; the rest replicate. cppre's flax leaves keep the out channel at
    dim 1 (Dense kernels [in, out], spectral weights [in, out, V, m1, m2]);
    here the real matrices are torch's [out, in, ...] (`_Linear`,
    `_Channel1x1`: out at dim 0) and the complex spectral weights keep
    [in, out, V, m1, m2] (out at dim 1), so each decides at its own out dim
    and reaches cppre's decision for its flax counterpart. `overrides` maps
    a name substring to explicit placements; `report=True` also returns
    {name: "sharded" | "replicated(<reason>)" | "override ..."}."""
    from torch.distributed.tensor import Replicate, Shard

    state = (model_or_state_dict.state_dict() if hasattr(model_or_state_dict, "state_dict")
             else model_or_state_dict)
    size = mesh.shape[axis]
    at = mesh.axis_names.index(axis)
    overrides = overrides or {}
    log, out = {}, {}
    for name, leaf in state.items():
        hit = next((pat for pat in overrides if pat in name), None)
        if hit is not None:
            out[name] = tuple(overrides[hit])
            log[name] = f"override {out[name]}"
            continue
        placements = [Replicate()] * len(mesh.axis_names)
        if leaf.ndim >= 2:
            d = 1 if leaf.is_complex() else 0
            if leaf.shape[d] % size == 0:
                placements[at] = Shard(d)
                log[name] = "sharded"
            else:
                log[name] = f"replicated(out dim {d}={leaf.shape[d]} % {size} != 0)"
        else:
            log[name] = "replicated(ndim<2)"
        out[name] = tuple(placements)
    return (out, log) if report else out


# ---- conformal calibration ------------------------------------------------

def sharded_calibrate(scores, alpha: float, mesh: Mesh, axis: str = "dp"):
    """Split-CP quantile of scores split over `axis` (a `Sharded` batch, or
    whole scores that each rank splits): every rank pads its block with
    +inf to the block length, the blocks are gathered, and the order
    statistic is taken at the index of the TRUE batch (`quantile_index`,
    float32 as in `calibrate`), so the padding never changes it: equal to
    `calibrate(scores, n, alpha)` bit for bit, on every rank."""
    from ..cp.inductive import cp_quantile_level, quantile_index

    part = shard_batch(scores, mesh, axis)
    n = part.sizes[0]
    gathered = torch.cat(_gather(part.padded(float("inf")), mesh, axis))
    k = quantile_index(cp_quantile_level(n, alpha), n, part.dtype)
    return torch.kthvalue(gathered, k + 1, dim=0).values


def _shape_from_rank0(shape, mesh: Mesh, axis: str):
    """Rank 0's `shape` along `axis` (its block is the first to hold rows)."""
    shapes = [None] * mesh.shape[axis]
    dist.all_gather_object(shapes, shape, group=mesh.group(axis))
    return shapes[0]


def sharded_fused_cp_scores(diff_stats_fn, truth, prediction, mesh: Mesh,
                            axis: str = "dp", eps: float = 1e-6) -> Sharded:
    """Joint-CP nonconformity scores with the batch split over `axis`: each
    rank runs `diff_stats_fn` (a `*_joint_cp_diff_stats` instance, kernel
    K1 on the card) on its own rows, and only the moment accumulators
    cross ranks. Returns this rank's scores as a `Sharded` batch, ready for
    `sharded_calibrate`.

    `diff_stats_fn(t, p)` gives (diff, sum, sumsq) as cppre's does, or
    (diff, sum, sumsq, m2) with m2 the centred sum of squares about its own
    rows' mean (K1's centred form, `_diff_stats_routed(..., centred=True)`);
    for a 3-tuple m2 is formed from the diff here. The port's scores take
    the modulation std from the centred sum (ops/kernels/stencil_kernels.py),
    and centred sums neither add across ranks nor tolerate cppre's
    zero-padded rows (each adds mean^2). So no rank pads, and the blocks'
    (sum, m2) are gathered (their counts follow from n) and combined in
    rank order by Chan's update, M2 = sum_r m2_r + n_r (mean_r - mean)^2, identical on every
    rank; on a one-rank mesh it is that rank's m2, bit for bit."""
    from ..ops.kernels.stencil_kernels import _scores_from_diff_stats

    t, p = shard_batch(truth, mesh, axis), shard_batch(prediction, mesh, axis)
    n, k = t.sizes[0], mesh.shape[axis]
    counts = [hi - lo for lo, hi in (_block(n, k, i) for i in range(k))]
    n_r = t.local.shape[0]
    if n_r:
        out = diff_stats_fn(t.local, p.local)
        diff, s = out[0], out[1]
        m2 = out[3] if len(out) > 3 and out[3] is not None else \
            torch.sum((diff.to(s.dtype) - s / n_r) ** 2, dim=0)
    if 0 in counts:         # an empty block learns the moments' shape from rank 0
        shape = _shape_from_rank0(tuple(s.shape) if n_r else None, mesh, axis)
        if not n_r:
            s = torch.zeros(shape, device=t.local.device)
            m2 = torch.zeros_like(s)
            diff = s.new_zeros((0,) + tuple(shape))
    moments = _gather(torch.stack((s, m2)), mesh, axis)
    mean = moments[0][0]
    for x in moments[1:]:
        mean = mean + x[0]
    mean = mean / n
    total = None
    for c, (s_r, m2_r) in zip(counts, moments):
        if c:
            term = m2_r + c * (s_r / c - mean) ** 2
            total = term if total is None else total + term
    scores = _scores_from_diff_stats(diff, total, n, eps)
    return Sharded(scores, mesh, (axis,), (0,), (n,))


# ---- data-parallel applies and training ------------------------------------

def make_sharded_fused_apply(model, mesh: Mesh, axis: str = "dp"):
    """dp-split drop-in for `models.fused.make_fused_apply(model)`: each rank
    runs the fused forward (K4/K5 on the card) on its own rows, zero-padded
    to the block length, and the output is cropped. Samples are independent
    in the forward, so pad rows never touch real ones. It takes a whole
    batch or a `Sharded` one and gives the output whole on every rank
    (`map_batch`). `apply_fn.local` is the per-rank apply."""
    from ..models.fused import make_fused_apply

    local = make_fused_apply(model)

    def apply_fn(x):
        return map_batch(local, mesh, x, axis=axis)

    apply_fn.local = local
    return apply_fn


def make_sharded_train_step(apply_fn, optimizer, step: int, T_out: int, loss_func,
                            mesh: Mesh, param_shardings=None, remat: bool | None = None):
    """`train.loops.make_train_step` with the batch split over 'dp': the
    same maths. Each rank runs the rollout loss on its own rows, the
    gradients are summed over 'dp' (in rank order) before the clip and
    Adam, and the loss and full loss come back summed. That is the
    global-batch step for a loss that SUMS over the batch, as `lp_loss`
    does by default (size_average=False); the batch must divide 'dp'.
    With `apply_fn = models.make_fused_train_apply(model)` every rank
    launches K4-K7.

    Ranks along 'tp' take the same rows and compute the same step. Each
    rank's module holds every parameter whole, so a parameter that
    `fno_param_shardings` places Shard(d) over 'tp' is used in its gathered
    form and the step equals the unsharded one; `param_shardings` is
    accepted for cppre's signature. `remat=None` checkpoints each rollout
    step on the card and not on the CPU, as cppre resolves it."""
    from ..models.fno import train_scope
    from ..train.loops import rollout_loss

    del param_shardings
    if remat is None:
        remat = mesh.device_type == "cuda"
    params = optimizer.params
    dp = mesh.shape["dp"]

    def sum_grads():
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([(torch.view_as_real(g) if g.is_complex() else g).reshape(-1)
                          for g in grads])
        flat = _sum(flat, mesh, "dp")
        at = 0
        for g in grads:
            view = torch.view_as_real(g) if g.is_complex() else g
            view.copy_(flat[at:at + view.numel()].view_as(view))
            at += view.numel()

    def train_step(xx, yy):
        x, y = shard_batch(xx, mesh, "dp"), shard_batch(yy, mesh, "dp")
        if x.sizes[0] % dp:
            raise ValueError(f"the train batch ({x.sizes[0]}) must divide dp ({dp}): a "
                             f"zero-padded sample has no relative loss")
        optimizer.zero_grad()
        with train_scope(apply_fn):
            loss, pred = rollout_loss(apply_fn, x.local, y.local, step, T_out, loss_func,
                                      remat=remat)
            loss.backward()
        sum_grads()
        optimizer.step()
        with torch.no_grad():
            full_loss = loss_func(pred, y.local)
        return _sum(loss.detach(), mesh, "dp"), _sum(full_loss, mesh, "dp")

    return train_step
