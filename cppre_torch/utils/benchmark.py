"""Timing harness and numeric-agreement assertion (port of
`cppre.utils.benchmark`).

`benchmark(fn, *args)` is `Benchmark(mean, std)` of wall seconds over
`num_iterations` calls, a first (warm-up) call discarded. On the card the
timed region ends in `torch.cuda.synchronize()`, the counterpart of the JAX
package's host fetch, so a call's queued kernels count in its time.
`assert_almost_equal` holds two results to the reference's FFT-vs-direct
tolerances: 5e-5 mean and 1e-4 max absolute error.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["Benchmark", "benchmark", "assert_almost_equal"]


class Benchmark(NamedTuple):
    mean: float
    std: float

    def __repr__(self):
        return f"Benchmark(mean: {self.mean * 1e3:.4f} ms, std: {self.std * 1e3:.4f} ms)"


def benchmark(fn: Callable, *args, num_iterations: int = 10, **kwargs) -> Benchmark:
    """Mean/std wall-clock over `num_iterations` calls, first discarded."""
    times = []
    for _ in range(num_iterations + 1):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        if torch.cuda.is_initialized():     # the card's queued work counts
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times = times[1:]
    return Benchmark(float(np.mean(times)), float(np.std(times)))


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_almost_equal(x, y, mean_tol: float = 5e-5, max_tol: float = 1e-4):
    """The reference's FFT-vs-direct agreement tolerance; tensors or arrays."""
    abs_error = np.abs(_numpy(x) - _numpy(y))
    assert abs_error.mean() < mean_tol, f"mean abs err {abs_error.mean():.2e} >= {mean_tol}"
    assert abs_error.max() < max_tol, f"max abs err {abs_error.max():.2e} >= {max_tol}"
