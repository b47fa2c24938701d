"""Dual-stream optical-flow tracking, GeoFlow-SLAM's headline stage (port
of geoflowslam_tpu/pipeline/of_tracking.py).

* 3D-prior stream: the last frame's keypoints bound to map points are
  forward-backward LK-tracked into the current frame over the fine pyramid
  levels, each starting at its map point's projection at the predicted
  pose, then gated by fundamental-matrix RANSAC. Survivors fill the current
  frame's reserved OF slots carrying their map-point binding.
* 2D stream: all of the last frame's keypoints are forward-backward tracked
  over the full pyramid, F-gated with half the sigma, spatially de-duplicated
  against the frame's keypoints and appended without a binding, keeping the
  last frame's descriptors.

Both streams are fixed-shape: the frame reserves `n_of_slots` padded slots
that this stage fills. Both streams' forward-backward tracks go through
ops/klt.fb_klt_track_streams together: one launch of the hand-written fused
kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from geoflowslam_tpu_torch.config import TrackConfig
from geoflowslam_tpu_torch.ops import klt as K
from geoflowslam_tpu_torch.ops import ransac
from geoflowslam_tpu_torch.pipeline.tracking import _project
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import FrameData


@dataclasses.dataclass(frozen=True)
class OFConfig:
    lk_win: int = 21             # LKWindowSize
    lk_iters: int = 10
    levels_3d: int = 3           # prior stream: fine levels only
    levels_2d: int = 6           # 2D stream: full pyramid (capped by frame)
    fb_thresh: float = 0.5       # forward-backward gate of BOTH streams
    f_ransac_hyp: int = 64
    f_sigma: float = 1.0         # 3D stream; the 2D stream uses half
    mask_radius: float = 8.0     # MASK_THRESHOLD spatial dedup
    min_eig: float = 1e-4


def of_dual_stream(ms: M.MapState, last_frame: FrameData,
                   cur_frame: FrameData, last_obs_mp: torch.Tensor,
                   pred_rot, pred_t, gen: Optional[torch.Generator],
                   cfg: TrackConfig, ofcfg: OFConfig, n_of_slots: int,
                   gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Fill cur_frame's last `n_of_slots` keypoint slots from the two
    streams (sources: all of the last frame's valid keypoints, including
    its own appended OF points).

    The F-RANSAC minimal sets are drawn from `gen`; `gumbel` = (noise of
    the 3D stream, noise of the 2D stream), each [f_ransac_hyp, N],
    replaces the draws. Returns (cur_frame with filled slots, obs_extra [N]
    with the map-point ids of the appended 3D-stream slots, n_3d, n_2d,
    of_innov [N]: per-slot distance between where a 3D-stream track landed
    and its start, 1e9 elsewhere)."""
    lf, cf = last_frame.feat, cur_frame.feat
    dev = cf.uv.device
    n_base = cf.capacity - n_of_slots
    pyr_prev = last_frame.lk_pyramid
    pyr_next = cur_frame.lk_pyramid
    lv3 = min(ofcfg.levels_3d, len(pyr_prev))
    lv2 = min(ofcfg.levels_2d, len(pyr_prev))
    lk = dict(fb_thresh=ofcfg.fb_thresh, win=ofcfg.lk_win,
              iters=ofcfg.lk_iters, min_eig=ofcfg.min_eig)
    noise3, noise2 = gumbel if gumbel is not None else (None, None)

    # ----- 3D-prior stream -------------------------------------------------
    has_mp = last_obs_mp >= 0
    mp_idx = torch.clamp_min(last_obs_mp, 0).long()
    mp_ok = has_mp & ms.mp_valid[mp_idx]
    uv_proj, _, in_img = _project(pred_rot, pred_t, ms.mp_pos[mp_idx], cfg)
    guess = torch.where((mp_ok & in_img)[:, None], uv_proj, lf.uv)
    # both streams' LK (the 2D stream starts at the keypoints themselves)
    r3, r2 = K.fb_klt_track_streams(pyr_prev, pyr_next, lf.uv, [guess, None],
                                    [lv3, lv2], **lk)
    ok3 = r3.status & mp_ok & lf.valid
    sets3 = ransac._sample_minimal_sets(gen, ok3, ofcfg.f_ransac_hyp, 8,
                                        noise=noise3)
    fres3 = ransac.ransac_fundamental(gen, lf.uv, r3.pts, ok3,
                                      sigma=ofcfg.f_sigma, sample_sets=sets3)
    ok3 = ok3 & fres3.inliers

    # ----- 2D stream -------------------------------------------------------
    ok2 = r2.status & lf.valid & ~ok3          # the 3D stream takes precedence
    sets2 = ransac._sample_minimal_sets(gen, ok2, ofcfg.f_ransac_hyp, 8,
                                        noise=noise2)
    fres2 = ransac.ransac_fundamental(gen, lf.uv, r2.pts, ok2,
                                      sigma=0.5 * ofcfg.f_sigma,
                                      sample_sets=sets2)
    ok2 = ok2 & fres2.inliers

    # ----- spatial dedup mask over a coarse grid ---------------------------
    cell = ofcfg.mask_radius
    gw = int(2 * cfg.cx / cell) + 2
    gh = int(2 * cfg.cy / cell) + 2
    n_cells = gw * gh

    def cells_of(uv, valid):
        # clamp before the int cast: failed tracks may lie far outside
        cxs = torch.clamp(uv[:, 0] / cell, -1.0, gw).to(torch.int32)
        cys = torch.clamp(uv[:, 1] / cell, -1.0, gh).to(torch.int32)
        flat = cys.clamp(0, gh - 1) * gw + cxs.clamp(0, gw - 1)
        return torch.where(valid, flat, n_cells).long()

    occ = torch.zeros((n_cells + 1,), dtype=torch.bool, device=dev)
    occ[cells_of(cf.uv, cf.valid)] = True
    c3 = cells_of(r3.pts, ok3)
    ok3 = ok3 & ~occ[torch.clamp_max(c3, n_cells - 1)]
    occ[torch.where(ok3, c3, n_cells)] = True
    c2 = cells_of(r2.pts, ok2)
    ok2 = ok2 & ~occ[torch.clamp_max(c2, n_cells - 1)]

    # ----- append into the reserved OF slots (3D survivors first) ----------
    pri = (torch.where(ok3, 2.0, torch.where(ok2, 1.0, 0.0))
           - 1e-6 * torch.arange(lf.capacity, dtype=torch.float32, device=dev))
    order = torch.argsort(-pri, stable=True)[:n_of_slots]
    src_ok3 = ok3[order]
    src_ok2 = ok2[order]
    any_ok = src_ok3 | src_ok2
    new_uv = torch.where(src_ok3[:, None], r3.pts[order],
                         torch.where(src_ok2[:, None], r2.pts[order], 0.0))
    sl = slice(n_base, n_base + n_of_slots)

    def put(full, part):
        out = full.clone()
        out[sl] = part
        return out

    # 3D-stream points take the map point's descriptor (Frame::AddPts); 2D
    # points keep the last frame's persistent track descriptor
    desc_src = torch.where(src_ok3[:, None], ms.mp_desc[mp_idx[order]],
                           lf.desc[order])
    feat = cf._replace(uv=put(cf.uv, new_uv), desc=put(cf.desc, desc_src),
                       angle=put(cf.angle, lf.angle[order]),
                       level=put(cf.level, lf.level[order]),
                       response=put(cf.response, lf.response[order]),
                       valid=put(cf.valid, any_ok))

    obs_extra = torch.full((cf.capacity,), M.NO_MP, dtype=torch.int32,
                           device=dev)
    obs_extra[sl] = torch.where(src_ok3, last_obs_mp[order], M.NO_MP)

    # innovation of the 3D-prior stream: a track that stayed at its start
    # (the projection at the predicted pose) only confirms the prediction;
    # the façade's health count discounts those
    innov3 = torch.linalg.norm(r3.pts - guess, dim=1)
    of_innov = torch.full((cf.capacity,), 1e9, device=dev)
    of_innov[sl] = torch.where(src_ok3, innov3[order], 1e9)

    cur2 = cur_frame._replace(feat=feat)
    if cur_frame.depth_img is not None:
        # depth of the appended slots from the kept depth image
        dimg = cur_frame.depth_img
        hh, ww = dimg.shape
        xi = torch.clamp(torch.round(torch.clamp(new_uv[:, 0], -1.0, ww)),
                         0, ww - 1).long()
        yi = torch.clamp(torch.round(torch.clamp(new_uv[:, 1], -1.0, hh)),
                         0, hh - 1).long()
        d_of = dimg[yi, xi]
        d_of = torch.where(any_ok & (d_of > 0), d_of, -1.0)
        ur_of = torch.where(
            d_of > 0, new_uv[:, 0] - cfg.bf / torch.clamp_min(d_of, 1e-6),
            -1.0)
        cur2 = cur2._replace(depth_kp=put(cur2.depth_kp, d_of),
                             u_right=put(cur2.u_right, ur_of))
    return (cur2, obs_extra, torch.sum(src_ok3), torch.sum(src_ok2 & any_ok),
            of_innov)
