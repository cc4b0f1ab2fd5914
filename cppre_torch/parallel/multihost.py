"""Multi-process entry point (port of `cppre.parallel.multihost`).

Each process calls `initialize()` once, then builds a global mesh over
every rank (`global_mesh`) and uses the same dp/tp/sp splits as a single
process. Nothing on a machine tells a program of its cluster: pass the
coordinator's address, the number of processes and this process's id, or
set torch's `env://` variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK).
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["initialize", "global_mesh"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device_type: str = "cuda"):
    """`torch.distributed.init_process_group` (`nccl` for cuda, `gloo` for
    cpu) over `tcp://<coordinator_address>`, or `env://` without one; a
    no-op for a single process. A benign double initialisation is
    ignored; any other RuntimeError surfaces, and so does the ValueError of
    an explicit but invalid configuration; without explicit arguments a
    ValueError (no `env://` variables: a single process) is a no-op."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or process_id is not None
    init = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    try:
        dist.init_process_group({"cuda": "nccl", "cpu": "gloo"}[device_type],
                                init_method=init, world_size=num_processes or -1,
                                rank=process_id if process_id is not None else -1)
    except RuntimeError as e:
        # benign double-initialize only; anything else must surface
        if "already" not in str(e).lower():
            raise
    except ValueError:
        if explicit:
            raise  # misconfiguration (bad address/process_id), not benign


def global_mesh(dp: int | None = None, tp: int = 1, axis_names=("dp", "tp"),
                device_type: str = "cuda"):
    """Mesh over every rank of the process group (call after initialize())."""
    from .sharding import make_mesh

    return make_mesh(None, dp=dp, tp=tp, axis_names=axis_names, device_type=device_type)
