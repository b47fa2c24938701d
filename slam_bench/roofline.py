"""The card's published peaks and the least time of the two kernels whose
roofline share the benchmark reports.

A frozen copy of chip_smoke.py's arithmetic (HBM_BYTES_PER_S,
F32_OPS_PER_S, FAST_OPS_PX, NMS_OPS_PX, bound_ms, lk_point_level_ops, and
the bytes and operations its fast_fused and lk_fused phases count), with
the shapes taken from a cell's configuration. Peaks: NVIDIA H100 SXM data
sheet, dense, at the full 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FAST at two thresholds: 16 ring terms of 17 operations, four arc tests of
# 11, six to combine; NMS and border mask of both maps: 2 x 10 + 2
FAST_OPS_PX = 16 * 17 + 4 * 11 + 6
NMS_OPS_PX = 2 * 10 + 2
# the optical-flow stage's track (pipeline/of_tracking.py's OFConfig): the
# 3D-prior stream over 3 levels, the 2D stream over the whole LK pyramid,
# one backward level, a 21 x 21 window, 10 Gauss-Newton steps
OF_LEVELS = (3, 6)
OF_FB_LEVELS = 1
OF_WIN = 21
OF_ITERS = 10


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds: every byte moved once at the memory rate, or every
    operation at the float32 rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def pyramid_shapes(h, w, n_levels, scale_factor):
    return [(int(round(h / scale_factor ** lvl)),
             int(round(w / scale_factor ** lvl))) for lvl in range(n_levels)]


def k1_fast_nms_bound_s(frame: dict) -> float:
    """One fused K1 launch: both thresholds, NMS and the border mask of
    every level of the ORB pyramid (4 bytes read, 8 written a pixel)."""
    orb = frame["orb"]
    shapes = pyramid_shapes(orb["height"], orb["width"], orb["n_levels"],
                            orb["scale_factor"])
    px = sum(h * w for h, w in shapes)
    px_fast = sum((h - 30) * (w - 30) for h, w in shapes)
    px_nms = sum((h - 32) * (w - 32) for h, w in shapes)
    return bound_s(12 * px, FAST_OPS_PX * px_fast + NMS_OPS_PX * px_nms)


def lk_point_level_ops(win: int, iters: int) -> int:
    """Float32 operations of one point on one level: the (win+2)^2
    template (7 a bilinear sample), gradients and structure tensor (10 a
    sample), a Gauss-Newton pass (12 a sample), the residual pass (9), and
    ~40 for the gate and the solves."""
    nw = win * win
    return (win + 2) ** 2 * 7 + nw * 10 + iters * nw * 12 + nw * 9 + 40


def k3_lk_pyramid_bound_s(frame: dict) -> float:
    """One fused K3 launch: both OF streams of every keypoint slot,
    forward over their levels and back over one, on the LK pyramid."""
    orb = frame["orb"]
    n_pts = orb["n_features"] + frame["n_of_slots"]
    lk_levels = frame.get("lk_levels", 4)
    levels = [min(lv, lk_levels) for lv in OF_LEVELS]
    point_levels = n_pts * sum(lv + OF_FB_LEVELS for lv in levels)
    h, w, used = orb["height"], orb["width"], max(levels)
    pyr_px = sum(-(-h // 2 ** lvl) * -(-w // 2 ** lvl)
                 for lvl in range(used))
    n_bytes = 2 * 4 * pyr_px + len(levels) * n_pts * 29
    return bound_s(n_bytes,
                   point_levels * lk_point_level_ops(OF_WIN, OF_ITERS))
