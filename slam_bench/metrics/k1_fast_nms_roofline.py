"""k1_fast_nms_roofline: the fused K1 (kernels/csrc/fast_scores.cu,
fast_nms_levels_kernel): its least time at the cell's pyramid
(slam_bench/roofline.py) over its mean device time a launch in the
profiled window, in %."""
from slam_bench import roofline

KERNEL = "fast_nms_levels_kernel"


def read(run):
    if run.trace is None:
        return None
    mean_s = run.trace.kernel_mean_s(KERNEL)
    if mean_s is None:
        return None
    return 100.0 * roofline.k1_fast_nms_bound_s(
        run.config["system"]["frame"]) / mean_s
