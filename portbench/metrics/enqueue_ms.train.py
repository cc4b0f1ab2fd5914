"""Mean host ms from a train step's call to its return, before the
synchronize: how far the host paces the step."""


def read(run):
    e = run.extra.get("enqueue_s")
    return 1e3 * sum(e) / len(e) if e else None
