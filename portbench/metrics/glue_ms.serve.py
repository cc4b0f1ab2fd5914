"""Device ms per request in work that is not one of the kernels K1-K12:
the elementwise glue, layout copies and library calls."""

from portbench.yardstick import ALL_KERNEL_NAMES


def read(run):
    if run.trace is None or not run.traced.completed:
        return None
    return 1e3 * run.trace.device_s_except(ALL_KERNEL_NAMES) / run.traced.completed
