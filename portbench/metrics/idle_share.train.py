"""The share of the traced window in which no kernel or memory operation
ran on the device, in %: 1 - busy seconds over the traced window's length,
both from the window under the (device-only) profiler."""


def read(run):
    t = run.traced
    if run.trace is None or t is None or t.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / t.window_s)
