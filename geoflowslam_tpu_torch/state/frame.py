"""Frame construction: images -> padded features, depth and cloud (port of
the RGB-D branch of geoflowslam_tpu/state/frame.py::build_frame, with the
raw feed and the packed m12 feed, io/feed_codec.py).

CLAHE, ORB extraction, depth association (virtual right-camera u from bf),
the voxel-downsampled depth cloud and the LK pyramid, as one FrameData of
fixed shapes on the input's device. With `n_of_slots` > 0 the feature set
ends in that many empty slots for the optical-flow stage to fill
(Frame::AddPts analogue), and the metric depth image is kept so that the
stage can give the appended points depth.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from geoflowslam_tpu_torch.config import FrameConfig
from geoflowslam_tpu_torch.io.feed_codec import unpack_m12_torch
from geoflowslam_tpu_torch.ops import klt as klt_ops
from geoflowslam_tpu_torch.ops import pointcloud as pc
from geoflowslam_tpu_torch.ops import pyramid as pyr_ops
from geoflowslam_tpu_torch.ops.extractor import FeatureSet, extract


class FrameData(NamedTuple):
    feat: FeatureSet            # padded keypoints + descriptors
    depth_kp: torch.Tensor      # [N] depth per keypoint (<=0 invalid)
    u_right: torch.Tensor       # [N] virtual right-cam u (RGB-D), <0 invalid
    cloud: torch.Tensor         # [P, 3] voxel-downsampled depth cloud (cam)
    cloud_valid: torch.Tensor   # [P]
    lk_pyramid: Tuple[torch.Tensor, ...]  # LK pyramid of the (CLAHE) gray
    # metric depth image [H, W], kept only when OF slots are reserved
    depth_img: Optional[torch.Tensor] = None


def check_supported(cfg: FrameConfig) -> None:
    """Raise on frame options the port does not have yet."""
    unsupported = []
    if cfg.camera_model != "pinhole" or cfg.dist_params:
        unsupported.append("distortion / non-pinhole camera")
    if cfg.lidar_features:
        unsupported.append("lidar_features")
    if cfg.feed_codec not in ("raw", "m12"):
        unsupported.append(f"feed_codec={cfg.feed_codec!r}")
    if unsupported:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(unsupported))


def build_frame(gray: torch.Tensor, depth: Optional[torch.Tensor],
                cfg: FrameConfig, fx, fy, cx, cy) -> FrameData:
    """gray: [H, W] 0..255 (any real dtype); depth: [H, W] depth x
    depth_map_factor. Both are cast to float32 on their device. A 1-D uint8
    `gray` is an m12 buffer (cfg.feed_codec == "m12"; `depth` is ignored),
    unpacked on its device into gray and depth in input units."""
    check_supported(cfg)
    if gray.dim() == 1:
        gray, depth = unpack_m12_torch(gray, cfg.orb.height, cfg.orb.width,
                                       cfg.depth_map_factor)
    gray = gray.float()
    depth = depth.float()
    img = pyr_ops.clahe(gray) if cfg.use_clahe else gray
    feat = extract(img, cfg.orb)

    xi = torch.clamp(torch.round(feat.uv[:, 0]).long(), 0, gray.shape[1] - 1)
    yi = torch.clamp(torch.round(feat.uv[:, 1]).long(), 0, gray.shape[0] - 1)
    d = depth[yi, xi] * cfg.depth_map_factor
    d = torch.where((d > 0) & (d < cfg.max_depth) & feat.valid, d, -1.0)
    ur = torch.where(d > 0, feat.uv[:, 0] - cfg.bf / torch.clamp_min(d, 1e-6),
                     -1.0)
    raw_pts, raw_mask = pc.depth_to_cloud(
        depth * cfg.depth_map_factor, fx, fy, cx, cy,
        stride=cfg.cloud_stride, max_depth=cfg.max_depth)
    cloud, cloud_valid = pc.voxel_downsample(
        raw_pts, raw_mask, cfg.cloud_voxel, cfg.cloud_max_pts)
    depth_img = None
    if cfg.n_of_slots > 0:
        k = cfg.n_of_slots

        def pad(x, value=0):
            return torch.cat([x, x.new_full((k,) + tuple(x.shape[1:]),
                                            value)])

        feat = FeatureSet(*(pad(x) for x in feat))
        # OF slots start without depth; the OF stage samples depth_img
        d, ur = pad(d, -1.0), pad(ur, -1.0)
        depth_img = depth * cfg.depth_map_factor
    pyr = tuple(klt_ops.build_lk_pyramid(img, cfg.lk_levels))
    return FrameData(feat=feat, depth_kp=d, u_right=ur, cloud=cloud,
                     cloud_valid=cloud_valid, lk_pyramid=pyr,
                     depth_img=depth_img)
