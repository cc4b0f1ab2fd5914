"""95th percentile of the judging path's request latency in the traced run."""

from portbench.core import p95


def read(run):
    if not run.latencies:
        return None
    return float("inf") if run.failed else 1e3 * p95(run.latencies)
