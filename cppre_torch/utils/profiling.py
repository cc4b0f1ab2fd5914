"""Profiling helpers: torch.profiler traces and wall-clock timers (port of
`cppre.utils.profiling`).

`trace(logdir)` records the enclosed block with `torch.profiler` (host
activity, and the card's where CUDA is available) and writes a Chrome trace,
viewable in Perfetto or chrome://tracing, under `logdir` when the block
ends; it yields `logdir`, as the JAX package's does. `timer()` is the
epoch-level wall clock.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

__all__ = ["trace", "timer"]


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "cppre_trace")):
    """Capture a torch.profiler trace of the enclosed block into
    `<logdir>/trace_<pid>_<ns>.json`. The profiler stays on until the block
    ends, also on an exception, and the trace is written then."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timer(label: str = "", sink=print):
    """Wall-clock the enclosed block (the reference's epoch-timer pattern)."""
    t0 = time.perf_counter()
    result = {"label": label, "seconds": None}
    try:
        yield result
    finally:
        result["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink(f"{label}: {result['seconds']:.3f}s")
