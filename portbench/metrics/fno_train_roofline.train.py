"""K4-K7 in the traced train steps: the summed roofline bound of their
launches (from the work of each step) over their device time, in %."""

from portbench.yardstick import names_of


def read(run):
    ids = ("K4", "K5", "K6", "K7")
    if run.trace is None or "fno_train_bound_s" not in run.work or not run.traced.launches_match(ids):
        return None
    t = run.trace.device_s(names_of(*ids))
    return 100 * run.traced.completed * run.work["fno_train_bound_s"] / t if t > 0 else None
