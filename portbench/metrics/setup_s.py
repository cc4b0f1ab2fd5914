"""Seconds from process start to the first timed item: imports, the kernels
from the program's cache (or their build, in a checkout's first run),
weights and inputs, calibration or the checked train steps, the warm-up."""


def read(run):
    return run.setup_s
