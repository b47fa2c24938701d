"""Lucas-Kanade pyramid of a frame (port of
geoflowslam_tpu/ops/klt.py::build_lk_pyramid). The tracker itself (the
TPU kernel lk_level_pallas) belongs to the optical-flow slice and is not
ported yet.
"""
from __future__ import annotations

from typing import List

import torch

from geoflowslam_tpu_torch.ops.pyramid import gaussian_blur


def build_lk_pyramid(img: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Half-resolution pyramid with 5x5 Gaussian smoothing per octave
    (cv::buildOpticalFlowPyramid analogue)."""
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(gaussian_blur(levels[-1], 5, 1.1)[::2, ::2])
    return levels
