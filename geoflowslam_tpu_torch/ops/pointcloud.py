"""Depth back-projection and voxel downsampling (port of the RGB-D part of
geoflowslam_tpu/ops/pointcloud.py). Clouds are fixed-capacity [P, 3]
tensors with validity masks.
"""
from __future__ import annotations

from typing import Tuple

import torch

INVALID_KEY = 0x7FFFFFFF


def depth_to_cloud(depth: torch.Tensor, fx, fy, cx, cy, stride: int = 3,
                   max_depth: float = 10.0, min_depth: float = 0.05):
    """Back-project a depth image [H, W] -> ([P, 3] points, [P] mask) with
    P = ceil(H / stride) * ceil(W / stride)."""
    d = depth[::stride, ::stride]
    hs, ws = d.shape
    ys = (torch.arange(hs, dtype=depth.dtype, device=depth.device)
          * stride)[:, None]
    xs = (torch.arange(ws, dtype=depth.dtype, device=depth.device)
          * stride)[None, :]
    z = d
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    mask = ((z > min_depth) & (z < max_depth) & torch.isfinite(z)).reshape(-1)
    return pts, mask


def _voxel_keys(pts: torch.Tensor, valid: torch.Tensor, voxel: float):
    """int32-range voxel key per point, 10 bits per axis (+-25 m at 5 cm);
    invalid points get INVALID_KEY and sort last."""
    ijk = torch.clamp(torch.floor(pts / voxel).long() + 512, 0, 1023)
    key = (ijk[:, 0] << 20) | (ijk[:, 1] << 10) | ijk[:, 2]
    return torch.where(valid, key, INVALID_KEY)


def voxel_downsample(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                     max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first point per voxel after a stable key sort, compacted to
    [max_out] (deterministic small_gicp::voxelgrid_sampling analogue)."""
    key = _voxel_keys(pts, valid, voxel)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=pts.device),
                       ks[1:] != ks[:-1]])
    first = first & (ks != INVALID_KEY)
    rank = torch.argsort((~first).to(torch.int8), stable=True)
    sel = order[rank[:max_out]]
    return pts[sel], first[rank[:max_out]]
