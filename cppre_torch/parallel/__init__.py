"""Scale-out on `torch.distributed`: meshes, sharding rules, halo-exchange
stencils, a sharded 2-D FFT and a pipelined FNO (port of `cppre.parallel`).

The port runs SPMD: every rank calls the same function (`torchrun`,
`torch.multiprocessing.spawn`), holds its block of each split value, and
meets the others in collectives, where cppre's single controller places
global arrays with `jax.sharding` (`sharding.py` says how results come
back).

* **dp**: calibration and training batches are embarrassingly parallel.
  `shard_batch` splits the sample axis over 'dp'; `map_batch` and
  `make_sharded_fused_apply` run a per-sample map (kernels K4/K5 on the
  card) on each rank's rows; `sharded_fused_cp_scores` runs K1 on each
  rank's rows and combines the moment accumulators across ranks;
  `sharded_calibrate` gives `calibrate`'s quantile exactly;
  `make_sharded_train_step` sums the gradients over 'dp' (K4-K7 with a
  fused training apply).
* **tp**: `fno_param_shardings` gives the tensor-parallel placement of the
  FNO's out-channel dims.
* **pp**: `make_pp_fno_apply` runs the 6 Fourier blocks as GPipe stages,
  microbatches hopping rank to rank; it composes with dp on a
  ('dp', 'pp') mesh and is differentiable.
* **sp**: `stencil_conv_sharded(_2d)` run a stencil on a spatially split
  field by exchanging k//2 ghost slabs; `fft2_sharded`/`ifft2_sharded`
  split the 2-D FFT itself (local 1-D FFTs and one all_to_all each way).

On the card a mesh is one rank on the one device (NCCL). Ranks > 1 run on
the CPU under gloo (`make_mesh(device_type="cpu")`): NCCL refuses two
ranks on one device.
"""

from .sharding import (
    Mesh,
    Sharded,
    make_mesh,
    map_batch,
    shard_batch,
    fno_param_shardings,
    sharded_calibrate,
    make_sharded_fused_apply,
    sharded_fused_cp_scores,
    make_sharded_train_step,
)
from .pipeline import make_pp_fno_apply, pp_supported
from .halo import stencil_conv_sharded, stencil_conv_sharded_2d
from .spectral import fft2_sharded, ifft2_sharded, spectral_circular_conv_sharded
from .multihost import initialize, global_mesh

__all__ = [
    "make_mesh",
    "shard_batch",
    "fno_param_shardings",
    "sharded_calibrate",
    "make_sharded_fused_apply",
    "sharded_fused_cp_scores",
    "make_sharded_train_step",
    "make_pp_fno_apply",
    "pp_supported",
    "stencil_conv_sharded",
    "stencil_conv_sharded_2d",
    "fft2_sharded",
    "ifft2_sharded",
    "spectral_circular_conv_sharded",
    "initialize",
    "global_mesh",
    "Mesh",
    "Sharded",
    "map_batch",
]
