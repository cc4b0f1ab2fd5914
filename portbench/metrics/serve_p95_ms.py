"""95th percentile of request latency over every request of the window; a
failed request counts as missing its limit (it makes the percentile inf)."""

from portbench.core import p95


def read(run):
    if not run.latencies:
        return None
    return float("inf") if run.failed else 1e3 * p95(run.latencies)
