"""Training samples of the completed steps over the whole window."""


def read(run):
    return run.samples / run.window_s if run.window_s > 0 and run.samples else None
