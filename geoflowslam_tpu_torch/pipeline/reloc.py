"""Relocalization core (port of geoflowslam_tpu/pipeline/reloc.py):
Tracking::Relocalization as BoW retrieval -> the mutual descriptor match of
every candidate (one K4 launch on the card for all candidates and both
directions) -> per candidate (GMS prune -> PnP RANSAC -> MLPnP refinement
-> pose-only GN) -> the candidate with the most inliers.

The reference vmaps over the top-3 candidates; here the matches are one
batched search and the rest runs in a loop, each candidate on its own
minimal sets drawn from the caller's generator.

`recover_frame` is the recovery step of the reference's fused frame step
(geoflowslam_tpu/pipeline/fused.py, its with_recovery variant): a 40 px
re-search from the predicted pose and a relocalization, the re-search taken
when it holds, adopted only well above the tracking floor.

Neither reads the device: candidate slots stay tensors, the best candidate
and stage are selected with `torch.where`/`index_select`, so the frame step
(pipeline/fused.py) runs them without a host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.config import TrackConfig
from geoflowslam_tpu_torch.ops import matching as MATCH
from geoflowslam_tpu_torch.ops import ransac as RS
from geoflowslam_tpu_torch.ops.gms import gms_filter
from geoflowslam_tpu_torch.pipeline import tracking as T
from geoflowslam_tpu_torch.retrieval import kf_database as DBD
from geoflowslam_tpu_torch.retrieval import vocab as Vv
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import FrameData


def _row(x: torch.Tensor, kf) -> torch.Tensor:
    """x[kf] for a slot given as an int or as a device scalar (gathered,
    never read back)."""
    if isinstance(kf, int):
        return x[kf]
    return x.index_select(0, kf.reshape(1).long())[0]


def reloc_candidate(ms: M.MapState, frame: FrameData, kf, ok_cand, uvn,
                    m_idx, gen: Optional[torch.Generator], tcfg: TrackConfig,
                    w: int, h: int, sample_sets=None):
    """One candidate KF (its slot an int or a device scalar) from its
    descriptor matches m_idx (frame keypoint -> KF keypoint or -1): GMS,
    PnP RANSAC, ML refinement, pose GN.
    Returns (n_inliers gated to 0, rot, t, obs_mp)."""
    feat = frame.feat
    # wide-baseline matches are outlier-heavy: the grid vote prunes them
    # before PnP RANSAC (SearchWithGMS)
    m_idx = gms_filter(feat.uv, _row(ms.kf_uv, kf), m_idx, (w, h), (w, h))
    mp = _row(ms.kf_obs_mp, kf)[torch.clamp_min(m_idx, 0).long()]
    mp_safe = torch.clamp_min(mp, 0).long()
    valid = (m_idx >= 0) & (mp >= 0) & ms.mp_valid[mp_safe] & ok_cand
    pts = ms.mp_pos[mp_safe]
    res = RS.ransac_pnp(gen, pts, uvn, valid, threshold_px=5.99,
                        focal=tcfg.fx, sample_sets=sample_sets)
    rot0, t0 = RS.refine_pnp_ml(res.model[:, :3], res.model[:, 3], pts, uvn,
                                res.inliers)
    obs_mp = torch.where(valid, mp, M.NO_MP)
    rot, t, obs2, n_inl = T.pose_opt_from_obs(ms, frame, obs_mp, rot0, t0,
                                              tcfg)
    gate = ok_cand & (valid.sum() >= 15) & (res.n_inliers >= 10)
    return torch.where(gate, n_inl, 0), rot, t, obs2


def reloc_core(vocab: Vv.Vocabulary, db: DBD.KFDatabase, ms: M.MapState,
               frame: FrameData, gen: Optional[torch.Generator],
               tcfg: TrackConfig, w: int, h: int, n_best: int = 3,
               sample_sets=None):
    """Relocalization over the top-`n_best` BoW candidates of the active
    map. `sample_sets` [n_best, 128, 6] replaces the PnP draws.

    Returns (n_inl, rot, t, obs_mp, cand_slot) of the best candidate;
    n_inl is the pose-GN inlier count the caller gates on
    (>= min_inliers_ok)."""
    feat = frame.feat
    words = Vv.descend(vocab, feat.desc, feat.valid)
    qvec = Vv.bow_vector(vocab, words)
    idx, _score, ok = DBD.detect_relocalization_candidates(db, ms, qvec,
                                                           n_best=n_best)
    uvn = torch.stack([(feat.uv[:, 0] - tcfg.cx) / tcfg.fx,
                       (feat.uv[:, 1] - tcfg.cy) / tcfg.fy], dim=1)
    kfs = idx.unbind(0)
    matches = MATCH.match_descriptors_many(
        [(feat.desc, feat.valid, _row(ms.kf_desc, kf),
          _row(ms.kf_kp_valid, kf) & (_row(ms.kf_obs_mp, kf) >= 0))
         for kf in kfs],
        max_dist=MATCH.TH_LOW, ratio=0.85, mutual=True)
    results = [reloc_candidate(
        ms, frame, kf, okc, uvn, m_idx, gen, tcfg, w, h,
        None if sample_sets is None else sample_sets[b])
        for b, (kf, okc, (m_idx, _)) in enumerate(zip(kfs, ok, matches))]
    # the best candidate (the first on ties), selected on the device
    b = torch.argmax(torch.stack([r[0] for r in results])).reshape(1)
    n_inl, rot, t, obs2 = (torch.stack(x).index_select(0, b)[0]
                           for x in zip(*results))
    return n_inl, rot, t, obs2, idx.index_select(0, b)[0]


class Recovery(NamedTuple):
    n_inliers: torch.Tensor     # [] int of the stage taken
    rot: torch.Tensor
    t: torch.Tensor
    obs_mp: torch.Tensor
    kf: torch.Tensor            # [] the matched KF (the reference KF on a
                                # re-search)
    relocalized: torch.Tensor   # [] bool: reloc_core gave the pose
    adopted: torch.Tensor       # [] bool: n_inliers >= max(min_inliers, 30)


def recover_frame(ms: M.MapState, frame: FrameData, last_obs_mp, pred_rot,
                  pred_t, ref_kf: int, last_levels, tcfg: TrackConfig,
                  min_inliers: int, relocalize: Callable) -> Recovery:
    """Recover a frame whose normal track failed, as the reference's fused
    step does (geoflowslam_tpu/pipeline/fused.py, _try_reloc and its gate):
    track_with_motion_model at a 40 px radius from the predicted pose
    against the last bindings, and `relocalize(frame)` (reloc_core's
    (n_inl, rot, t, obs_mp, cand)); the re-search is taken when it keeps
    `min_inliers`, else the relocalization. The result is adopted at
    >= max(min_inliers, 30) inliers (`adopted`). Both stages always run and
    the choice is made on the device."""
    wide = dataclasses.replace(tcfg, search_radius_mm=40.0)
    res = T.track_with_motion_model(ms, frame, last_obs_mp, pred_rot, pred_t,
                                    wide, last_levels)
    n_r, rot, t, obs, cand = relocalize(frame)
    use_w = res.n_inliers >= min_inliers
    n = torch.where(use_w, res.n_inliers, n_r)
    return Recovery(n, torch.where(use_w, res.rot, rot),
                    torch.where(use_w, res.t, t),
                    torch.where(use_w, res.obs_mp, obs),
                    torch.where(use_w, ref_kf, cand), ~use_w,
                    n >= max(min_inliers, 30))
