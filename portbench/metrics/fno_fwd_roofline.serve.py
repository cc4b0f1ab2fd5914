"""K4 and K5 in the traced window: the summed roofline bound of their
launches (from the work of each request) over their device time, in %."""

from portbench.yardstick import names_of


def read(run):
    if run.trace is None or "fno_fwd_bound_s" not in run.work or not run.traced.launches_match(("K4", "K5")):
        return None
    t = run.trace.device_s(names_of("K4", "K5"))
    return 100 * run.traced.completed * run.work["fno_fwd_bound_s"] / t if t > 0 else None
