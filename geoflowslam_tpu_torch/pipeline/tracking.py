"""Tracking stages (port of geoflowslam_tpu/pipeline/tracking.py, RGB-D):

* `stereo_initialization`   <- Tracking::StereoInitialization
* `track_with_motion_model` <- TrackWithMotionModel: project the last
  frame's map points at the predicted pose, gated projection search (the
  CUDA kernel on the card), pose-only GN.
* `track_reference_keyframe` <- TrackReferenceKeyFrame: BoW-word-gated
  mutual matching against the reference KF, rotation consistency,
  pose-only GN (the plain masked search: no TPU kernel computed it).
* `track_local_map`         <- TrackLocalMap + SearchLocalPoints: covisible
  window candidates, frustum gates, projection search, pose-only GN, the
  found/visible counters.
* `create_keyframe`         <- CreateNewKeyFrame, RGB-D close points.
* `mean_reproj_error`       <- the per-frame mFrame2FrameReprojErr /
  mFrame2MapReprojErr bookkeeping.

Where two sources scatter to one keypoint slot the highest source row wins,
as XLA's sequential scatter does (ops/indexing.scatter_set).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.config import TH_HIGH, TrackConfig
from geoflowslam_tpu_torch.ops import matching
from geoflowslam_tpu_torch.ops.indexing import scatter_set, topk_stable
from geoflowslam_tpu_torch.solvers import pose_opt
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import FrameData


class TrackResult(NamedTuple):
    rot: torch.Tensor
    t: torch.Tensor
    obs_mp: torch.Tensor     # [N] mp id per current-frame keypoint (-1 none)
    n_inliers: torch.Tensor  # [] int


def inv_sigma2(levels: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Per-octave information weight (ORB-SLAM mvInvLevelSigma2)."""
    return 1.0 / (scale_factor ** levels.float()) ** 2


def _project(rot, t, pts_w, cfg: TrackConfig):
    pc = pts_w @ rot.T + t
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cfg.fx * pc[:, 0] / zs + cfg.cx
    v = cfg.fy * pc[:, 1] / zs + cfg.cy
    in_img = ((u >= 0) & (u < 2 * cfg.cx) & (v >= 0) & (v < 2 * cfg.cy)
              & (z > 0.1))
    return torch.stack([u, v], dim=1), z, in_img


def _unproject(frame: FrameData, cfg: TrackConfig):
    """Camera-frame points of the keypoints at their associated depth."""
    feat = frame.feat
    z = torch.clamp_min(frame.depth_kp, 1e-6)
    x = (feat.uv[:, 0] - cfg.cx) / cfg.fx * z
    y = (feat.uv[:, 1] - cfg.cy) / cfg.fy * z
    return torch.stack([x, y, z], dim=1)


def _new_point_stats(d, level, cfg: TrackConfig):
    """Viewing normal and scale-invariance distances of new points from the
    camera-to-point vector d [N, 3]."""
    dist = torch.linalg.norm(d, dim=1)
    max_d = dist * cfg.scale_factor ** level.float()
    min_d = max_d / (cfg.scale_factor ** (cfg.n_levels - 1))
    return dist, max_d, min_d


def stereo_initialization(ms: M.MapState, frame: FrameData, time: float,
                          kf_slot: int, cfg: TrackConfig):
    """First KF + map points from depth, at the identity pose. Every valid
    keypoint with depth becomes a map point. Returns (ms, TrackResult)."""
    feat = frame.feat
    dev = feat.uv.device
    rot0 = torch.eye(3, device=dev)
    t0 = torch.zeros(3, device=dev)
    make = feat.valid & (frame.depth_kp > 0)
    pos = _unproject(frame, cfg)
    ms, mp_slots = M.free_mp_slots(ms, feat.capacity, use_mask=make)
    obs_mp = torch.where(make, mp_slots, M.NO_MP).to(torch.int32)
    norm = -pos / torch.clamp_min(torch.linalg.norm(pos, dim=1, keepdim=True),
                                  1e-6)
    _, max_d, min_d = _new_point_stats(pos, feat.level, cfg)
    ms = M.insert_keyframe(ms, kf_slot, rot0, t0, time, feat.uv, feat.level,
                           feat.angle, feat.desc, frame.depth_kp, feat.valid,
                           obs_mp, -1)
    ms = M.add_map_points(ms, mp_slots, pos, feat.desc, norm, min_d, max_d,
                          kf_slot, make)
    return ms, TrackResult(rot0, t0, obs_mp, make.sum())


def pose_opt_from_obs(ms: M.MapState, frame: FrameData, obs_mp, rot0, t0,
                      cfg: TrackConfig):
    """Pose-only GN over the frame's bound map points; drops outliers from
    the binding. Returns (rot, t, obs_mp, n_inliers)."""
    feat = frame.feat
    mp_idx = torch.clamp_min(obs_mp, 0).long()
    valid = (obs_mp >= 0) & ms.mp_valid[mp_idx] & feat.valid
    obs = pose_opt.PoseObs(
        pts_w=ms.mp_pos[mp_idx], uv=feat.uv, u_right=frame.u_right,
        is_stereo=valid & (frame.u_right > 0),
        inv_sigma2=inv_sigma2(feat.level, cfg.scale_factor), valid=valid)
    rot, t, inl, n_inl = pose_opt.pose_optimization(
        rot0, t0, obs, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf)
    return rot, t, torch.where(inl, obs_mp, M.NO_MP), n_inl


def track_with_motion_model(ms: M.MapState, frame: FrameData,
                            last_obs_mp: torch.Tensor, pred_rot, pred_t,
                            cfg: TrackConfig,
                            last_levels: torch.Tensor,
                            extra_obs: torch.Tensor | None = None
                            ) -> TrackResult:
    """Project the last frame's map points at the predicted pose and match
    them with radius th * scale^octave and the octave window [oct-1, oct+1]
    of the last frame's keypoints, then pose-only GN. `extra_obs` [N] holds
    map-point ids bound beforehand (the optical-flow appends,
    pipeline/of_tracking.py); they fill the keypoints the search left
    unmatched."""
    feat = frame.feat
    mp_idx = torch.clamp_min(last_obs_mp, 0).long()
    mp_ok = (last_obs_mp >= 0) & ms.mp_valid[mp_idx]
    uv_proj, _, in_img = _project(pred_rot, pred_t, ms.mp_pos[mp_idx], cfg)
    radius = cfg.search_radius_mm * cfg.scale_factor ** last_levels.float()
    m_idx, _ = matching.search_by_projection(
        uv_proj, last_levels, mp_ok & in_img, ms.mp_desc[mp_idx],
        feat.uv, feat.level, feat.desc, feat.valid, radius,
        max_dist=cfg.match_max_dist)
    empty = torch.full((feat.capacity,), M.NO_MP, dtype=torch.int32,
                       device=feat.uv.device)
    obs_mp = scatter_set(empty, torch.where(m_idx >= 0, m_idx, -1),
                         mp_idx.to(torch.int32))
    if extra_obs is not None:
        obs_mp = torch.where(obs_mp == M.NO_MP, extra_obs, obs_mp)
    rot, t, obs_mp, n_inl = pose_opt_from_obs(ms, frame, obs_mp, pred_rot,
                                              pred_t, cfg)
    return TrackResult(rot, t, obs_mp, n_inl)


def track_reference_keyframe(ms: M.MapState, frame: FrameData,
                             words_frame, words_kf, ref_kf: int, rot0, t0,
                             cfg: TrackConfig) -> TrackResult:
    """Match the frame against the reference KF's map points where both
    keypoints descend to the same vocabulary word (SearchByBoW), keep the
    rotation-consistent matches, then pose-only GN from (rot0, t0)."""
    feat = frame.feat
    kf_obs = ms.kf_obs_mp[ref_kf]
    kf_ok = (ms.kf_kp_valid[ref_kf] & (kf_obs >= 0)
             & ms.mp_valid[torch.clamp_min(kf_obs, 0).long()])
    same_word = ((words_frame[:, None] == words_kf[None, :])
                 & (words_frame >= 0)[:, None] & (words_kf >= 0)[None, :])
    m_idx, _ = matching.match_descriptors(
        feat.desc, feat.valid, ms.kf_desc[ref_kf], kf_ok,
        max_dist=matching.TH_LOW, ratio=0.7, mutual=True, mask=same_word)
    m_idx = matching.rotation_consistency(feat.angle, ms.kf_angle[ref_kf],
                                          m_idx)
    obs_mp = torch.where(m_idx >= 0, kf_obs[torch.clamp_min(m_idx, 0).long()],
                         M.NO_MP)
    rot, t, obs_mp, n_inl = pose_opt_from_obs(ms, frame, obs_mp, rot0, t0,
                                              cfg)
    return TrackResult(rot, t, obs_mp, n_inl)


def track_local_map(ms: M.MapState, frame: FrameData, obs_mp: torch.Tensor,
                    rot, t, cfg: TrackConfig, local_masks):
    """Search the local window's map points not yet matched, then pose-only
    GN over all matches, and update the visible/found counters.
    `local_masks` = (kf_mask, mp_mask, cand_idx) from M.local_window.
    Returns (ms, TrackResult)."""
    feat = frame.feat
    dev = feat.uv.device
    _, mp_mask, cand_idx = local_masks
    cand_valid = ms.mp_valid[cand_idx] & mp_mask[cand_idx]
    pos_c = ms.mp_pos[cand_idx]
    uv_proj, _, in_img = _project(rot, t, pos_c, cfg)
    already = torch.zeros((ms.m_max,), dtype=torch.bool, device=dev)
    already = scatter_set(already, torch.clamp_min(obs_mp, 0), obs_mp >= 0)
    cand = cand_valid & in_img & ~already[cand_idx]

    # frustum gates (Frame::isInFrustum): distance inside the point's
    # scale-invariance band, viewing direction within 60 deg of its normal
    cam_center = -(rot.T @ t)
    dvec = pos_c - cam_center
    dist = torch.linalg.norm(dvec, dim=1)
    min_d_c = ms.mp_min_dist[cand_idx]
    max_d_c = ms.mp_max_dist[cand_idx]
    scale_ok = (dist > 0.8 * min_d_c) & (dist < 1.2 * max_d_c)
    cand = cand & (scale_ok | (max_d_c <= 0))
    view = dvec / torch.clamp_min(dist, 1e-6)[:, None]
    normal_c = ms.mp_normal[cand_idx]
    vcos = torch.sum(view * normal_c, dim=1)
    has_normal = torch.sum(normal_c ** 2, dim=1) > 0.25
    cand = cand & ((vcos > 0.5) | ~has_normal)

    # predicted octave from distance (MapPoint::PredictScale)
    log_sf = torch.log(torch.tensor(cfg.scale_factor, dtype=torch.float32))
    ratio_d = torch.clamp_min(max_d_c, 1e-6) / torch.clamp_min(dist, 1e-6)
    level_pred = torch.clamp(torch.ceil(torch.log(ratio_d) / log_sf.to(dev)),
                             0, cfg.n_levels - 1).to(torch.int32)
    r_view = torch.where(vcos >= 0.998, 0.5, 0.8)
    radius = (cfg.search_radius_lm * r_view
              * cfg.scale_factor ** level_pred.float())
    m_idx, _ = matching.search_by_projection(
        uv_proj, level_pred, cand, ms.mp_desc[cand_idx],
        feat.uv, feat.level, feat.desc, feat.valid & ~(obs_mp >= 0),
        radius, max_dist=TH_HIGH)

    visible_add = torch.zeros((ms.m_max,), device=dev).index_add_(
        0, cand_idx, cand.float())
    new_obs = scatter_set(obs_mp, torch.where(m_idx >= 0, m_idx, -1),
                          cand_idx.to(torch.int32))
    new_obs = torch.where(obs_mp >= 0, obs_mp, new_obs)

    rot2, t2, final_obs, n_inl = pose_opt_from_obs(ms, frame, new_obs, rot, t,
                                                   cfg)
    found_add = torch.zeros((ms.m_max,), device=dev).index_add_(
        0, torch.clamp_min(final_obs, 0).long(), (final_obs >= 0).float())
    ms = ms._replace(mp_visible=ms.mp_visible + visible_add + found_add,
                     mp_found=ms.mp_found + found_add)
    return ms, TrackResult(rot2, t2, final_obs, n_inl)


def mean_reproj_error(ms: M.MapState, frame: FrameData, obs_mp, rot, t,
                      cfg: TrackConfig) -> torch.Tensor:
    """Mean pixel reprojection error over the frame's bound map points in
    front of the camera (0 when there is none)."""
    feat = frame.feat
    safe = torch.clamp_min(obs_mp, 0).long()
    has = (obs_mp >= 0) & feat.valid & ms.mp_valid[safe]
    uv, z, _ = _project(rot, t, ms.mp_pos[safe], cfg)
    err = torch.linalg.norm(uv - feat.uv, dim=1)
    ok = has & (z > 0.1)
    return (torch.sum(torch.where(ok, err, 0.0))
            / torch.clamp_min(torch.sum(ok.float()), 1.0))


def create_keyframe(ms: M.MapState, frame: FrameData, rot, t, time: float,
                    obs_mp: torch.Tensor, prev_kf: int, kf_slot: int,
                    cfg: TrackConfig):
    """Insert a KF at `kf_slot` and create map points from depth for up to
    max_new_mp_per_kf unbound keypoints, closest first.
    Returns (ms, n_new)."""
    feat = frame.feat
    n = feat.capacity
    dev = feat.uv.device
    depth_ok = (frame.depth_kp < cfg.close_depth) if cfg.close_depth > 0 \
        else torch.ones_like(feat.valid)
    make = feat.valid & (obs_mp == M.NO_MP) & (frame.depth_kp > 0) & depth_ok
    order_key = torch.where(make, frame.depth_kp, float("inf"))
    _, order = topk_stable(order_key, min(cfg.max_new_mp_per_kf, n),
                           largest=False)
    sel = torch.zeros((n,), dtype=torch.bool, device=dev)
    sel[order] = True
    make = make & sel

    rot_wc = rot.T
    cam_center = -rot_wc @ t
    pos_w = _unproject(frame, cfg) @ rot_wc.T + cam_center
    ms, mp_slots = M.free_mp_slots(ms, n, use_mask=make)
    obs_all = torch.where(make, mp_slots, obs_mp.long()).to(torch.int32)
    d = pos_w - cam_center
    dist, max_d, min_d = _new_point_stats(d, feat.level, cfg)
    norm = d / torch.clamp_min(dist[:, None], 1e-6)
    ms = M.insert_keyframe(ms, kf_slot, rot, t, time, feat.uv, feat.level,
                           feat.angle, feat.desc, frame.depth_kp, feat.valid,
                           obs_all, prev_kf)
    ms = M.add_map_points(ms, mp_slots, pos_w, feat.desc, norm, min_d, max_d,
                          kf_slot, make)
    return ms, make.sum()
