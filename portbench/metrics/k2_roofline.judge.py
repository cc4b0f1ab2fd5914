"""K2 in the traced judging window: its roofline bound over its device time, in %."""

from portbench.yardstick import names_of


def read(run):
    if run.trace is None or "k2_bound_s" not in run.work or not run.traced.launches_match(("K2",)):
        return None
    t = run.trace.device_s(names_of("K2"))
    return 100 * run.traced.completed * run.work["k2_bound_s"] / t if t > 0 else None
