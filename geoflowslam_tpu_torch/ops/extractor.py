"""Full ORB extraction: pyramid -> FAST -> orientation -> rBRIEF (port of
geoflowslam_tpu/ops/extractor.py). Returns one fixed-shape FeatureSet with
all levels merged and coordinates scaled to level 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.config import OrbConfig
from geoflowslam_tpu_torch.ops import fast as fast_ops
from geoflowslam_tpu_torch.ops import orb as orb_ops
from geoflowslam_tpu_torch.ops import pyramid as pyr_ops


class FeatureSet(NamedTuple):
    """Padded keypoint set for one image (N = OrbConfig.n_features)."""
    uv: torch.Tensor        # [N, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # [N]
    angle: torch.Tensor     # [N] radians
    level: torch.Tensor     # [N] int32 octave
    desc: torch.Tensor      # [N, 8] int32 (256 descriptor bits)
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self):
        return self.uv.shape[0]


def extract(img: torch.Tensor, cfg: OrbConfig) -> FeatureSet:
    """img: [H, W] float32 grayscale in [0, 255] -> FeatureSet[n_features]."""
    levels = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    # both thresholds' maps of every level, finished: one kernel launch
    maps = fast_ops.fast_nms_levels(levels, cfg.min_th_fast, cfg.ini_th_fast)
    uvs, resps, angles, lvls, descs, valids = [], [], [], [], [], []
    for lvl, (lv_img, (s_low, s_high), quota, scale) in enumerate(
            zip(levels, maps, cfg.per_level_quota(), cfg.scale_factors())):
        if quota == 0:
            continue
        kp = fast_ops.detect_level(s_low, s_high, quota,
                                   cell_size=cfg.cell_size,
                                   per_cell_cap=cfg.per_cell_cap)
        ang, d = orb_ops.orient_and_describe(lv_img, kp.xy)
        uvs.append(kp.xy * scale)
        resps.append(kp.score)
        angles.append(ang)
        lvls.append(torch.full((quota,), lvl, dtype=torch.int32,
                               device=img.device))
        descs.append(d)
        valids.append(kp.valid)
    return FeatureSet(
        uv=torch.cat(uvs), response=torch.cat(resps), angle=torch.cat(angles),
        level=torch.cat(lvls), desc=torch.cat(descs), valid=torch.cat(valids))
