"""k3_lk_pyramid_roofline: the fused K3 (kernels/csrc/lk_level.cu,
lk_pyramid_kernel): its least time for both optical-flow streams of every
keypoint slot (slam_bench/roofline.py) over its mean device time a launch
in the profiled window, in %. For a cell with optical flow
(g1_vi_geoflow); no listed cell has one."""
from slam_bench import roofline

KERNEL = "lk_pyramid_kernel"


def read(run):
    if run.trace is None:
        return None
    mean_s = run.trace.kernel_mean_s(KERNEL)
    if mean_s is None:
        return None
    return 100.0 * roofline.k3_lk_pyramid_bound_s(
        run.config["system"]["frame"]) / mean_s
