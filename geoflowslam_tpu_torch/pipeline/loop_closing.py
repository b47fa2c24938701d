"""Loop closing: place recognition, Sim3 verification, loop correction and
Atlas merge (port of geoflowslam_tpu/pipeline/loop_closing.py).

The LoopClosing thread becomes a `LoopCloser` the façade calls after each
keyframe's mapping step:
* place recognition: BoW query against the KF database with
  covisibility-group scoring and temporal consistency over 3 chains
  (`detect_step`);
* geometric verification: mutual descriptor matching of the two KFs' map
  points (the K4 kernel on the card), Sim3 RANSAC, Sim3 GN, a
  guided-projection count (the K2 kernel on the card) and the planar-
  consensus gate (`verify_sim3`);
* a drift-budget gate for same-map loops;
* correction: an Atlas merge when the candidate is in a dormant map, then
  the essential-graph pose-graph GN with map points re-anchored through
  their reference KF (`correct_loop`), the seam welded by `fuse_pair` and a
  welding local BA, and optionally a synchronous global BA (landmark-
  sharded over `mesh` when one is given: parallel/dist_ba.py).
"""
from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from geoflowslam_tpu_torch.config import (TH_HIGH, TH_LOW, LoopConfig,
                                          MappingConfig)
from geoflowslam_tpu_torch.math.sym_eig import eigvals3
from geoflowslam_tpu_torch.ops import matching, ransac
from geoflowslam_tpu_torch.ops.indexing import topk_stable
from geoflowslam_tpu_torch.pipeline import local_mapping as LM
from geoflowslam_tpu_torch.retrieval import kf_database as DB
from geoflowslam_tpu_torch.retrieval import vocab as V
from geoflowslam_tpu_torch.solvers import pose_graph as PG
from geoflowslam_tpu_torch.state import map_state as M


def extract_essential_edges(ms: M.MapState, cur: int, cand: int, s, rot, t,
                            covis_edge_min: float, max_edges: int,
                            cov=None) -> PG.PoseGraphEdges:
    """The essential graph's edges: covisibility edges over the threshold
    and the temporal chain, picked by one masked top-k over the [K, K]
    covisibility matrix, with the relative poses measured from the current
    poses; the verified loop edge (i = cand, j = cur, the measured Sim3)
    takes the last slot."""
    k = ms.k_max
    dev = ms.kf_valid.device
    if cov is None:
        cov = M.covisibility(ms)
    cov = cov.float()
    valid2 = ms.kf_valid[:, None] & ms.kf_valid[None, :]
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=dev), 1)
    w = torch.where((cov >= covis_edge_min) & upper & valid2,
                    torch.clamp_max(cov, 100.0) / 100.0, 0.0)
    # temporal chain: edge (prev[j], j) at the reference's strong weight
    prev = ms.kf_prev.long()
    t_ok = ms.kf_valid & (prev >= 0) & ms.kf_valid[torch.clamp_min(prev, 0)]
    rows = torch.where(t_ok, prev, 0)
    cols = torch.arange(k, device=dev)
    w = _scatter_max(w, rows, cols, torch.where(t_ok, 1.0, 0.0))
    # at most K^2 slots (the reference's top_k needs K^2 >= max_edges - 1)
    n_e = min(max_edges - 1, k * k)
    vals, flat = topk_stable(w.reshape(-1), n_e)
    ei, ej = flat // k, flat % k
    ev = vals > 0.0
    ri, ti = ms.kf_rot[ei], ms.kf_t[ei]
    rj, tj = ms.kf_rot[ej], ms.kf_t[ej]
    r_rel = torch.einsum("eab,ecb->eac", ri, rj)            # R_i R_j^T
    t_rel = ti - torch.einsum("eab,eb->ea", r_rel, tj)
    one = lambda x: torch.as_tensor(x, device=dev)[None]    # noqa: E731
    return PG.PoseGraphEdges(
        i=torch.cat([ei, one(cand).long()]),
        j=torch.cat([ej, one(cur).long()]),
        s=torch.cat([torch.ones((n_e,), device=dev),
                     one(s).float().reshape(1)]),
        rot=torch.cat([r_rel, rot[None]], dim=0),
        t=torch.cat([t_rel, t[None]], dim=0),
        weight=torch.cat([vals, torch.tensor([5.0], device=dev)]),
        valid=torch.cat([ev, torch.tensor([True], device=dev)]))


def _scatter_max(w, rows, cols, vals):
    """w.at[rows, cols].max(vals) (duplicate targets keep the largest)."""
    k = w.shape[1]
    flat = w.reshape(-1).scatter_reduce(0, rows * k + cols, vals, "amax",
                                        include_self=True)
    return flat.reshape(w.shape)


def count_projection_matches(ms: M.MapState, cur: int, cand: int, s, rot, t,
                             cfg: MappingConfig) -> torch.Tensor:
    """Project the candidate KF's map points into the current KF's camera
    through the verified camera-frame Sim3 (p_cand = s R p_cur + t, so
    p_cur = R^T (p_cand - t) / s) and count descriptor matches near the
    projections (FindMatchesByProjection)."""
    obs = ms.kf_obs_mp[cand]
    mp = torch.clamp_min(obs, 0).long()
    has = (obs >= 0) & ms.kf_kp_valid[cand] & ms.mp_valid[mp]
    p_cand = ms.mp_pos[mp] @ ms.kf_rot[cand].T + ms.kf_t[cand]
    p_cur = (p_cand - t) @ rot / torch.clamp_min(s, 1e-9)
    z = torch.where(torch.abs(p_cur[:, 2]) < 1e-6, 1e-6, p_cur[:, 2])
    u = cfg.fx * p_cur[:, 0] / z + cfg.cx
    v = cfg.fy * p_cur[:, 1] / z + cfg.cy
    inb = ((p_cur[:, 2] > 0.1) & (u >= 0) & (u < 2 * cfg.cx) & (v >= 0)
           & (v < 2 * cfg.cy))
    radius = torch.full((obs.shape[0],), 8.0, device=obs.device)
    m_idx, _ = matching.search_by_projection(
        torch.stack([u, v], dim=1), torch.zeros_like(obs), has & inb,
        ms.mp_desc[mp], ms.kf_uv[cur], ms.kf_level[cur], ms.kf_desc[cur],
        ms.kf_kp_valid[cur], radius, max_dist=TH_HIGH,
        min_off=0, max_off=8)   # octave-free verification window
    return torch.sum(m_idx >= 0).to(torch.int32)


def verify_sim3(ms: M.MapState, cur: int, cand: int,
                gen: Optional[torch.Generator], fix_scale: bool,
                cfg: MappingConfig, sample_sets=None):
    """Geometric verification of a matured loop candidate: map-point
    descriptor matching -> Sim3 RANSAC -> GN refinement -> guided-projection
    count, plus the out-of-plane thickness of the inlier consensus (a planar
    consensus aliases texture-period shifts into consistent Sim3s).

    Returns (scalars [4] int32 = [n_ransac_inl, n_opt_inl, n_proj,
    thickness_mm], s, R, t) with (s, R, t) mapping cur-KF camera coordinates
    to cand-KF camera coordinates."""
    m_idx, _ = matching.match_descriptors(
        ms.kf_desc[cur], ms.kf_kp_valid[cur] & (ms.kf_obs_mp[cur] >= 0),
        ms.kf_desc[cand], ms.kf_kp_valid[cand] & (ms.kf_obs_mp[cand] >= 0),
        max_dist=TH_LOW, ratio=0.85, mutual=True)
    mp1 = ms.kf_obs_mp[cur]
    mp2 = ms.kf_obs_mp[cand][torch.clamp_min(m_idx, 0).long()]
    valid = (m_idx >= 0) & (mp1 >= 0) & (mp2 >= 0)
    p1c = ms.mp_pos[torch.clamp_min(mp1, 0).long()] @ ms.kf_rot[cur].T \
        + ms.kf_t[cur]
    p2c = ms.mp_pos[torch.clamp_min(mp2, 0).long()] @ ms.kf_rot[cand].T \
        + ms.kf_t[cand]
    res = ransac.ransac_sim3(gen, p1c, p2c, valid, fix_scale=fix_scale,
                             threshold=0.1, sample_sets=sample_sets)
    s0, r0, t0 = res.model[0], res.model[1:10].reshape(3, 3), res.model[10:13]
    s, rot, t, inl = PG.optimize_sim3_pair(s0, r0, t0, p1c, p2c, res.inliers,
                                           fix_scale=fix_scale)
    n_proj = count_projection_matches(ms, cur, cand, s, rot, t, cfg)
    w = inl.to(p1c.dtype)
    nw = torch.clamp_min(torch.sum(w), 1.0)
    mean1 = torch.sum(p1c * w[:, None], dim=0) / nw
    c1 = (p1c - mean1) * w[:, None]
    lam = eigvals3((c1.T @ c1 / nw)[None])[0]
    thickness_mm = torch.sqrt(torch.clamp_min(lam[0], 0.0)) * 1e3
    scalars = torch.stack([res.n_inliers.to(torch.int32),
                           inl.sum().to(torch.int32), n_proj,
                           thickness_mm.to(torch.int32)])
    return scalars, s, rot, t


def detect_step(vocab: V.Vocabulary, db: DB.KFDatabase, ms: M.MapState,
                kf_slot: int, prev_groups, prev_counts, min_score: float,
                n_best: int = 3):
    """Per-KF place recognition and temporal-consistency update: BoW
    descent, DetectNBestCandidates, the database insert and the
    consistent-groups bookkeeping (mvConsistentGroups) over `n_best` chains:
    a candidate's count is 1 + the largest count of any previous group it
    overlaps.

    Returns (db', groups [n_best, K] bool, counts [n_best] int32, scalars
    [n_best, 3] int32 rows = (cand_idx, count, score * 1e4))."""
    dev = ms.kf_valid.device
    words = V.descend(vocab, ms.kf_desc[kf_slot], ms.kf_kp_valid[kf_slot])
    qvec = V.bow_vector(vocab, words)
    cov = M.covisibility(ms)
    cand_idx, cand_score, cand_ok = DB.detect_candidates(
        db, ms, qvec, kf_slot, n_best=n_best, cov=cov)
    db = DB.set_entry(db, kf_slot, qvec)
    ok = cand_ok & (cand_score >= min_score)
    groups = cov[cand_idx.long()] > 0                          # [n_best, K]
    groups[torch.arange(n_best, device=dev), cand_idx.long()] = True
    groups = groups & ok[:, None]
    overlap = (groups.float() @ prev_groups.float().T) > 0
    inherited = torch.max(torch.where(overlap, prev_counts[None, :], 0),
                          dim=1).values
    counts = torch.where(ok, 1 + inherited, 0).to(torch.int32)
    scalars = torch.stack([cand_idx.to(torch.int32), counts,
                           (cand_score * 1e4).to(torch.int32)], dim=1)
    return db, groups, counts, scalars


def correct_loop(ms: M.MapState, cur: int, cand: int, s, rot, t,
                 cfg: LoopConfig, yaw_only: bool = False) -> M.MapState:
    """Essential-graph pose-graph optimisation with the loop constraint:
    the candidate KF is held fixed and every map point moves with its
    reference KF's correction, X' = S_new^-1 S_old X."""
    k = ms.k_max
    dev = ms.kf_valid.device
    base_s = torch.ones((k,), device=dev)
    base_rot, base_t = ms.kf_rot, ms.kf_t
    edges = extract_essential_edges(ms, cur, cand, s, rot, t,
                                    float(cfg.covis_edge_min), cfg.max_edges)
    fixed = torch.zeros((k,), dtype=torch.bool, device=dev)
    fixed[cand] = True
    s_new, r_new, t_new = PG.optimize_pose_graph(
        base_s, base_rot, base_t, ms.kf_valid, fixed, edges,
        fix_scale=cfg.fix_scale, iters=10, yaw_only=yaw_only)
    ref = torch.clamp(ms.mp_first_kf.long(), 0, k - 1)
    pcam = torch.einsum("mij,mj->mi", base_rot[ref], ms.mp_pos) + base_t[ref]
    sn = torch.clamp_min(s_new[ref], 1e-9)
    pw = torch.einsum("mji,mj->mi", r_new[ref],
                      (pcam - t_new[ref]) / sn[:, None])
    return ms._replace(
        kf_rot=torch.where(ms.kf_valid[:, None, None], r_new, ms.kf_rot),
        kf_t=torch.where(ms.kf_valid[:, None],
                         t_new / torch.clamp_min(s_new, 1e-9)[:, None],
                         ms.kf_t),
        mp_pos=torch.where(ms.mp_valid[:, None], pw, ms.mp_pos))


class LoopCloser:
    """Host-side loop-closing stage (one call per new KF)."""

    GEN_SEED = 77    # the RANSAC generator's seed

    def __init__(self, vocab: V.Vocabulary, k_max: int,
                 cfg: LoopConfig = LoopConfig(),
                 map_cfg: Optional[MappingConfig] = None, mesh=None, *,
                 device):
        self.vocab = vocab
        # an optional parallel.dist_ba.LandMesh: the synchronous global BA
        # then runs landmark-sharded
        self.mesh = mesh
        self.cfg = cfg
        self.device = torch.device(device)
        self.db = DB.KFDatabase.create(k_max, vocab.n_words, self.device)
        self.n_loops = 0
        self.n_merges = 0
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.GEN_SEED)
        self._map_cfg = map_cfg if map_cfg is not None else MappingConfig()
        self.n_cand = 3
        self.k_max = k_max
        self._reset_chains()
        PG.warm_forward_ad(self.device)

    def _reset_chains(self):
        self._groups = torch.zeros((self.n_cand, self.k_max),
                                   dtype=torch.bool, device=self.device)
        self._counts = torch.zeros((self.n_cand,), dtype=torch.int32,
                                   device=self.device)

    def matured_candidate(self, scalars_np) -> Optional[int]:
        """The first candidate whose chain reached the consistency gate."""
        for cand, count, _score in np.asarray(scalars_np).tolist():
            if count >= self.cfg.consistency_needed:
                return int(cand)
        return None

    def on_keyframe(self, ms: M.MapState, kf_slot: int,
                    inertial: bool = False,
                    kf_clouds: Optional[dict] = None):
        """Detect, and for a matured candidate verify and correct.
        Returns (ms, loop_found)."""
        self.db, self._groups, self._counts, scalars = detect_step(
            self.vocab, self.db, ms, kf_slot, self._groups, self._counts,
            self.cfg.min_score, self.n_cand)
        best = self.matured_candidate(scalars.cpu())
        if best is None:
            return ms, False
        return self.complete_candidate(ms, int(kf_slot), best,
                                       inertial=inertial, kf_clouds=kf_clouds)

    def complete_candidate(self, ms: M.MapState, cur: int, best: int,
                           inertial: bool = False,
                           kf_clouds: Optional[dict] = None):
        """Verification and correction of a consistency-matured candidate
        (NewDetectCommonRegions' tail -> CorrectLoop / MergeLocal).
        Returns (ms, loop_found)."""
        ok, s, rot, t, _n_inl, n_proj = self._verify(ms, cur, best)
        if not ok or n_proj < self.cfg.min_proj_verify:
            return ms, False
        if (self.cfg.use_icp_loop and kf_clouds is not None
                and cur in kf_clouds and best in kf_clouds):
            from geoflowslam_tpu_torch.ops import gicp as G
            c1, v1 = kf_clouds[cur]
            c2, v2 = kf_clouds[best]
            reg = G.gicp_register(c1, v1, c2, v2, init_rot=rot, init_t=t)
            if int(reg.n_inliers) >= self.cfg.min_sim3_inliers:
                rot, t = reg.rot, reg.t
                s = torch.ones((), device=rot.device)
        same_map = int(ms.kf_map_id[best]) == int(ms.kf_map_id[cur])
        if same_map and not self._within_drift_budget(ms, cur, best, s, rot,
                                                      t):
            return ms, False
        if not same_map:
            # the verified Sim3 is camera-frame (p_cand = s R p_cur + t);
            # merge_maps applies a world-frame one, through both KF poses:
            # s_w = s, R_w = R2^T R R1, t_w = R2^T (s R t1 + t - t2)
            r1, t1 = ms.kf_rot[cur], ms.kf_t[cur]
            r2, t2 = ms.kf_rot[best], ms.kf_t[best]
            r_w = r2.T @ rot @ r1
            t_w = r2.T @ (s * (rot @ t1) + t - t2)
            ms = M.merge_maps(ms, ms.kf_map_id[cur], ms.kf_map_id[best], s,
                              r_w, t_w)
            self.n_merges += 1
        if self.cfg.run_pose_graph:
            ms = correct_loop(ms, cur, best, s, rot, t, self.cfg,
                              yaw_only=inertial)
        if self.cfg.run_weld:
            # SearchAndFuse across the corrected seam (cur <-> cand and
            # cand's strongest covisible KF), then a welding local BA
            cov_b = M.covisibility(ms)[best]
            nb_best = int(torch.argmax(cov_b))
            ms = LM.fuse_pair(ms, cur, best, self._map_cfg)
            if int(cov_b[nb_best]) > 0 and nb_best != cur:
                ms = LM.fuse_pair(ms, cur, nb_best, self._map_cfg)
            ms, _ = LM.local_ba_step(ms, cur, self._map_cfg)
        if self.cfg.run_global_ba:
            if self.mesh is not None:
                ms = LM.global_ba_step_distributed(ms, self._map_cfg,
                                                   self.mesh)
            else:
                ms = LM.global_ba_step(ms, self._map_cfg)
        self.n_loops += 1
        self._reset_chains()
        return ms, True

    def _verify(self, ms: M.MapState, cur: int, cand: int):
        scalars, s, rot, t = verify_sim3(ms, cur, cand, self.gen,
                                         self.cfg.fix_scale, self._map_cfg)
        n_ransac, n_opt, n_proj, thick_mm = scalars.tolist()
        ok = (n_ransac >= self.cfg.min_sim3_inliers
              and n_opt >= self.cfg.min_sim3_inliers)
        if ok and thick_mm < 1e3 * self.cfg.min_structure_m:
            warnings.warn(f"loop candidate {cur}->{cand} rejected: planar "
                          f"consensus ({thick_mm} mm thick)")
            ok = False
        return ok, s, rot, t, n_opt, n_proj

    def _within_drift_budget(self, ms: M.MapState, cur: int, best: int, s,
                             rot, t) -> bool:
        """A same-map loop's implied correction E = T_meas T_odom^-1 must be
        within floor + rate * |t_cur - t_cand| of translation and rotation,
        and its scale within e^0.2."""
        c = self.cfg
        r1, t1 = (x.double().cpu().numpy() for x in (ms.kf_rot[cur],
                                                     ms.kf_t[cur]))
        r2, t2 = (x.double().cpu().numpy() for x in (ms.kf_rot[best],
                                                     ms.kf_t[best]))
        r_o = r2 @ r1.T
        t_o = t2 - r_o @ t1
        r_m, t_m = rot.double().cpu().numpy(), t.double().cpu().numpy()
        s_m = float(s)
        r_e = r_m @ r_o.T
        t_e = t_m - s_m * (r_e @ t_o)
        dt_sec = abs(float(ms.kf_time[cur]) - float(ms.kf_time[best]))
        budget_t = c.drift_budget_floor_m + c.drift_budget_rate * dt_sec
        budget_r = math.radians(c.drift_budget_floor_deg
                                + c.drift_budget_rate_deg * dt_sec)
        ang = math.acos(float(np.clip((np.trace(r_e) - 1) / 2, -1, 1)))
        if (np.linalg.norm(t_e) > budget_t or ang > budget_r
                or abs(math.log(max(s_m, 1e-9))) > 0.2):
            warnings.warn(f"loop candidate {cur}->{best} rejected by the "
                          f"drift budget: |t_err| {np.linalg.norm(t_e):.2f} m "
                          f"(budget {budget_t:.2f}), rot_err "
                          f"{math.degrees(ang):.1f} deg (budget "
                          f"{math.degrees(budget_r):.1f}), s {s_m:.3f}")
            return False
        return True
