"""Samples served over the whole window, each with its residual, sets and
accept flag (and its prediction where the cell rolls out)."""


def read(run):
    return run.samples / run.window_s if run.window_s > 0 and run.samples else None
