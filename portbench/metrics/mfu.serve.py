"""Model flops of the completed rollouts over the window times the float32
peak, in %, from the traced run's window without the profiler."""

from portbench.yardstick import F32_FLOPS_PER_S


def read(run):
    if "model_flops" not in run.work or run.window_s <= 0:
        return None
    return 100 * run.completed * run.work["model_flops"] / (run.window_s * F32_FLOPS_PER_S)
