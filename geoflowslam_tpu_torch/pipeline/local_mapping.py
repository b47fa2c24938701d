"""Local mapping per keyframe (port of the visual part of
geoflowslam_tpu/pipeline/local_mapping.py).

`mapping_step` runs the LocalMapping::Run body once per new keyframe, in
the reference's order: KF insertion with RGB-D point creation -> Schur
local BA over the covisibility window -> duplicate fusion with the five
best covisible KFs (the gated Hamming search, the CUDA kernel on the card)
-> descriptor/normal refresh -> map-point culling -> KF culling -> the
local-window recompute for the tracker.

Monocular KFs create their points by triangulation instead
(`triangulate_new_points`, CreateNewMapPoints): mutual ratio-0.8 matches of
the unbound keypoints against each of the three best covisible KFs (one
best-two Hamming launch a neighbour, both directions in it), epipolar
triangulation with reprojection, depth and parallax gates.

With an IMU, VI-BA over the temporal KF window (`vi_ba_step`) takes the
local BA's place.

After a loop or a merge: `fuse_pair` welds the two loop ends, and the global
BA runs either at once (`global_ba_step`) or as `AsyncGBA`, one GN iteration
per tracked frame with the corrections propagated on write-back
(LoopClosing::RunGlobalBundleAdjustment). Given a parallel.dist_ba.LandMesh,
both run the landmark-sharded iteration instead
(`global_ba_step_distributed`, `AsyncGBA(mesh=...)`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.config import TH_LOW, MappingConfig, TrackConfig
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.math.triangulate import triangulate_points_f64
from geoflowslam_tpu_torch.ops import matching
from geoflowslam_tpu_torch.ops.indexing import (scatter_set, scatter_set_2d,
                                                topk_stable)
from geoflowslam_tpu_torch.parallel import dist_ba
from geoflowslam_tpu_torch.pipeline import tracking as T
from geoflowslam_tpu_torch.solvers import inertial_ba as VIBA
from geoflowslam_tpu_torch.solvers import local_ba
from geoflowslam_tpu_torch.state import map_state as M


# ---------------------------------------------------------------------------
# BA window extraction / write-back
# ---------------------------------------------------------------------------

def select_window(ms: M.MapState, center_kf: int, cfg: MappingConfig):
    """The optimized window (top covisible KFs of the centre, centre first)
    plus the fixed ring (KFs that see the window's points), with at least
    two fixed KFs for the gauge.
    Returns (kf_idx [KW], in_window [KW] bool, fixed [KW] bool)."""
    dev = ms.kf_valid.device
    inc = M.observation_incidence(ms)
    cov = M.covisibility(ms, incidence=inc)
    row = cov[center_kf] * ms.kf_valid * (ms.kf_map_id == ms.active_map)
    row[center_kf] = 1 << 20
    vals, idx = topk_stable(row, cfg.window_opt)
    opt_mask_k = torch.zeros((ms.k_max,), dtype=torch.bool, device=dev)
    opt_mask_k[idx] = vals > 0

    window_mps = (opt_mask_k.float() @ inc) > 0
    sees_window = (inc @ window_mps.float()) > 0
    ring = sees_window & ~opt_mask_k & ms.kf_valid
    rvals, ridx = topk_stable(ring.to(torch.int32) * (1 + cov[center_kf]),
                              cfg.window_fixed)
    kf_idx = torch.cat([idx, ridx])
    in_win = torch.cat([vals > 0, rvals > 0])
    fixed = torch.cat([torch.zeros((cfg.window_opt,), dtype=torch.bool,
                                   device=dev),
                       torch.ones((cfg.window_fixed,), dtype=torch.bool,
                                  device=dev)])
    n_fixed = (fixed & in_win).sum()
    times = torch.where(in_win & ~fixed, ms.kf_time[kf_idx], float("inf"))
    oldest1 = torch.argmin(times)
    times2 = times.clone()
    times2[oldest1] = float("inf")
    oldest2 = torch.argmin(times2)
    fixed1 = fixed.clone()
    fixed1[oldest1] = True
    fixed = torch.where(n_fixed >= 1, fixed, fixed1)
    n_fixed = (fixed & in_win).sum()
    fixed2 = fixed.clone()
    fixed2[oldest2] = True
    fixed = torch.where(n_fixed >= 2, fixed, fixed2)
    return kf_idx, in_win, fixed


def _clamped(ms: M.MapState, kf_idx):
    """Window slots for reads: a padding slot (k_max) reads the last row,
    as an out-of-range XLA gather does; writes to it are dropped."""
    return torch.clamp(kf_idx, max=ms.k_max - 1)


def extract_ba_problem(ms: M.MapState, kf_idx, in_win, fixed,
                       cfg: MappingConfig):
    """Dense BAProblem over the window KFs and the `ba_max_pts` landmarks
    they observe most. Padding slots (k_max) must be out of the window.
    Returns (problem, mp_idx, mp_in, ctx)."""
    dev = ms.kf_valid.device
    kw = kf_idx.shape[0]
    m = ms.m_max
    kf_idx = _clamped(ms, kf_idx)
    opt_sel = in_win & ~fixed
    obs = ms.kf_obs_mp[kf_idx].long()                             # [KW, N]
    kp_valid = ms.kf_kp_valid[kf_idx]
    ov = (obs >= 0) & kp_valid & ms.kf_valid[kf_idx][:, None] \
        & opt_sel[:, None]
    mp_score = torch.zeros((m + 1,), device=dev).index_add_(
        0, torch.where(ov, obs, m).reshape(-1),
        torch.ones((obs.numel(),), device=dev))[:m] * ms.mp_valid
    mvals, mp_idx = topk_stable(mp_score, cfg.ba_max_pts)
    mp_in = mvals > 0
    lookup = torch.full((m + 1,), -1, dtype=torch.long, device=dev)
    lookup[mp_idx] = torch.arange(cfg.ba_max_pts, device=dev)

    local_m = lookup[torch.clamp(obs, -1, m)]
    has = (obs >= 0) & (local_m >= 0) & kp_valid & in_win[:, None]
    uv_kp = ms.kf_uv[kf_idx]
    d_kp = ms.kf_depth[kf_idx]
    ur_kp = torch.where(d_kp > 0,
                        uv_kp[..., 0] - cfg.bf / torch.clamp_min(d_kp, 1e-6),
                        -1.0)
    ml = cfg.ba_max_pts
    tgt = torch.where(has, local_m, ml)
    kk = torch.arange(kw, device=dev)[:, None].expand(obs.shape)

    def grid(val, tail=()):
        z = torch.zeros((kw, ml) + tail, dtype=val.dtype, device=dev)
        return scatter_set_2d(z, kk, tgt, val)

    ur = grid(ur_kp)
    prob = local_ba.BAProblem(
        kf_rot=ms.kf_rot[kf_idx], kf_t=ms.kf_t[kf_idx],
        kf_fixed=fixed | ~in_win, kf_valid=in_win,
        pts=ms.mp_pos[mp_idx], pt_valid=mp_in,
        uv=grid(uv_kp, (2,)), u_right=ur, is_stereo=ur > 0,
        inv_sigma2=grid(T.inv_sigma2(ms.kf_level[kf_idx], cfg.scale_factor)),
        obs_valid=grid(torch.ones_like(has)),
    )
    return prob, mp_idx, mp_in, (kk, has, local_m, obs)


def writeback_ba(ms: M.MapState, out: local_ba.BAProblem, obs_inl, kf_idx,
                 in_win, fixed, mp_idx, mp_in, ctx) -> M.MapState:
    kk, has, local_m, obs = ctx
    upd = in_win & ~fixed
    kr = _clamped(ms, kf_idx)
    ms = ms._replace(
        kf_rot=scatter_set(ms.kf_rot, kf_idx, torch.where(
            upd[:, None, None], out.kf_rot, ms.kf_rot[kr])),
        kf_t=scatter_set(ms.kf_t, kf_idx, torch.where(
            upd[:, None], out.kf_t, ms.kf_t[kr])),
        mp_pos=scatter_set(ms.mp_pos, mp_idx, torch.where(
            mp_in[:, None], out.pts, ms.mp_pos[mp_idx])),
    )
    bad = out.obs_valid & ~obs_inl
    bad_kp = bad[kk, torch.where(has, local_m, 0)] & has
    new_obs = torch.where(bad_kp, M.NO_MP, obs).to(torch.int32)
    return ms._replace(kf_obs_mp=scatter_set(ms.kf_obs_mp, kf_idx, new_obs))


def local_ba_step(ms: M.MapState, center_kf: int, cfg: MappingConfig):
    """Extract the covisibility window, run Schur BA, write back.
    Returns (ms, number of BA observations)."""
    kf_idx, in_win, fixed = select_window(ms, center_kf, cfg)
    prob, mp_idx, mp_in, ctx = extract_ba_problem(ms, kf_idx, in_win, fixed,
                                                  cfg)
    out, obs_inl = local_ba.local_bundle_adjustment(
        prob, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf)
    ms = writeback_ba(ms, out, obs_inl, kf_idx, in_win, fixed, mp_idx, mp_in,
                      ctx)
    return ms, prob.obs_valid.sum()


# ---------------------------------------------------------------------------
# Fusion, point statistics, culling
# ---------------------------------------------------------------------------

def keyframe_culling(ms: M.MapState, center_kf: int,
                     protect_recent: float = 1.0, redundancy: float = 0.9,
                     min_obs_level: int = 3, incidence=None):
    """KeyFrameCulling: the most redundant local KF (>= 90% of its points seen
    by >= 3 KFs, > 20 points, not a map origin, older than protect_recent s)
    is erased. Returns (ms, culled slot or -1 as a [] tensor)."""
    inc = M.observation_incidence(ms) if incidence is None else incidence
    n_obs = torch.sum(inc, dim=0)
    own = inc > 0
    redundant_pts = own & (n_obs[None, :] >= min_obs_level)
    n_own = torch.clamp_min(own.sum(dim=1), 1)
    frac = redundant_pts.sum(dim=1) / n_own
    protected = ms.kf_time >= ms.kf_time[center_kf] - protect_recent
    cand = (ms.kf_valid & ~protected & ~(ms.kf_prev < 0)
            & (ms.kf_map_id == ms.active_map) & (frac > redundancy)
            & (own.sum(dim=1) > 20))
    best = torch.argmax(torch.where(cand, frac, -1.0))
    do_cull = cand[best]
    culled = ms._replace(kf_prev=torch.where(ms.kf_prev == best,
                                             ms.kf_prev[best], ms.kf_prev))
    culled = M.erase_keyframe(culled, best)
    ms = ms._replace(**{f: torch.where(do_cull, getattr(culled, f),
                                       getattr(ms, f))
                        for f in ("kf_valid", "kf_obs_mp", "kf_kp_valid",
                                  "kf_prev")})
    return ms, torch.where(do_cull, best, -1).to(torch.int32)


def global_ba_step(ms: M.MapState, cfg: MappingConfig, ba_pts: int = 4096):
    """GlobalBundleAdjustemnt: all KFs of the active map with its two oldest
    fixed (the gauge), over the `ba_pts` most observed landmarks."""
    in_win, fixed = _gba_window(ms)
    prob, mp_idx, mp_in, ctx = _gba_extract(ms, in_win, fixed, cfg, ba_pts)
    out, obs_inl = local_ba.local_bundle_adjustment(
        prob, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, iters1=5, iters2=10)
    kf_idx = torch.arange(ms.k_max, device=in_win.device)
    return writeback_ba(ms, out, obs_inl, kf_idx, in_win, fixed, mp_idx,
                        mp_in, ctx)


def global_ba_step_distributed(ms: M.MapState, cfg: MappingConfig, mesh,
                               ba_pts: int = 4096, iters: int = 10):
    """The global BA over a parallel.dist_ba.LandMesh: the landmarks cut
    into the mesh's shards, `iters` sharded GN steps (Huber on each, no
    re-gating), then the inliers recomputed on the optimised problem for the
    write-back's edge pruning. ba_pts must be divisible by the mesh size."""
    in_win, fixed = _gba_window(ms)
    prob, mp_idx, mp_in, ctx = _gba_extract(ms, in_win, fixed, cfg, ba_pts)
    out = dist_ba.make_distributed_ba(mesh, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                      cfg.bf, iters=iters)(prob)
    r, _, _, behind = local_ba.residuals(out, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                         cfg.bf)
    th = torch.where(out.is_stereo, local_ba.CHI2_STEREO, local_ba.CHI2_MONO)
    inl = out.obs_valid & (local_ba.chi2(r, out) <= th) & ~behind
    kf_idx = torch.arange(ms.k_max, device=in_win.device)
    return writeback_ba(ms, out, inl, kf_idx, in_win, fixed, mp_idx, mp_in,
                        ctx)


def _gba_window(ms: M.MapState):
    """Every valid KF of the active map; the two oldest fixed."""
    in_win = ms.kf_valid & (ms.kf_map_id == ms.active_map)
    times = torch.where(in_win, ms.kf_time, float("inf"))
    o1 = torch.argmin(times)
    times2 = times.clone()
    times2[o1] = float("inf")
    o2 = torch.argmin(times2)
    fixed = torch.zeros((ms.k_max,), dtype=torch.bool, device=in_win.device)
    fixed[o1] = True
    fixed[o2] = True
    return in_win, fixed


def _gba_extract(ms: M.MapState, in_win, fixed, cfg: MappingConfig,
                 ba_pts: int):
    kf_idx = torch.arange(ms.k_max, device=in_win.device)
    return extract_ba_problem(ms, kf_idx, in_win, fixed,
                              dataclasses.replace(cfg, ba_max_pts=ba_pts))


class AsyncGBA:
    """Abortable global BA as interleaved micro-steps
    (RunGlobalBundleAdjustment's detached thread with its abort flag):
    `start` snapshots the problem, the caller runs one GN iteration per
    frame with `step`, `abort` drops it (mbStopGBA), and `finish` writes the
    result back, carrying the corrections to KFs inserted meanwhile through
    the temporal chain and to the other points through their reference KF."""

    def __init__(self, cfg: MappingConfig, ba_pts: int = 4096,
                 iters_total: int = 15, mesh=None):
        self.cfg = cfg
        self.ba_pts = ba_pts
        self.iters_total = iters_total
        self.active = False
        self.i = 0
        self._prob = None
        # an optional parallel.dist_ba.LandMesh: each micro-step is then one
        # landmark-sharded iteration instead of the one-device GN step
        self.mesh = mesh
        self._dist_iter = None

    def start(self, ms: M.MapState):
        in_win, fixed = _gba_window(ms)
        prob, mp_idx, mp_in, _ = _gba_extract(ms, in_win, fixed, self.cfg,
                                              self.ba_pts)
        self._prob = prob
        self._active_mask = (prob.obs_valid & prob.pt_valid[None, :]
                             & prob.kf_valid[:, None])
        self._mp_idx, self._mp_in = mp_idx, mp_in
        self._in_win, self._fixed = in_win, fixed
        self.i = 0
        self.active = True

    def abort(self):
        self.active = False
        self._prob = None

    def step(self) -> bool:
        """One GN iteration; returns True when the budget is done."""
        if not self.active:
            return False
        c = self.cfg
        if self.mesh is not None:
            if self._dist_iter is None:
                self._dist_iter = dist_ba.make_distributed_ba(
                    self.mesh, c.fx, c.fy, c.cx, c.cy, c.bf, iters=1)
            self._prob = self._dist_iter(self._prob)
        else:
            self._prob = local_ba._gn_step(self._prob, self._active_mask,
                                           c.fx, c.fy, c.cx, c.cy, c.bf, True)
        self.i += 1
        return self.i >= self.iters_total

    def finish(self, ms: M.MapState) -> M.MapState:
        out = self._prob
        self.active = False
        self._prob = None
        return _gba_writeback(ms, out, self._in_win, self._mp_idx,
                              self._mp_in)


def _gba_writeback(ms: M.MapState, out: local_ba.BAProblem, in_win, mp_idx,
                   mp_in) -> M.MapState:
    """Write optimised poses and points; propagate the corrections to state
    created during the run (KFs via the temporal chain, points via their
    reference KF)."""
    k = ms.k_max
    new_rot = torch.where(in_win[:, None, None], out.kf_rot, ms.kf_rot)
    new_t = torch.where(in_win[:, None], out.kf_t, ms.kf_t)
    corrected = in_win
    prev = ms.kf_prev.long()
    pr = torch.clamp_min(prev, 0)
    for _ in range(4):
        # KFs inserted during the run: T_c_new = T_c_now T_r_now^-1 T_r_new
        can = ms.kf_valid & ~corrected & (prev >= 0) & corrected[pr]
        r_now, t_now = ms.kf_rot[pr], ms.kf_t[pr]
        dr = torch.einsum("kba,kbc->kac", r_now, new_rot[pr])
        dtv = torch.einsum("kba,kb->ka", r_now, new_t[pr] - t_now)
        cr = torch.einsum("kab,kbc->kac", ms.kf_rot, dr)
        ct = torch.einsum("kab,kb->ka", ms.kf_rot, dtv) + ms.kf_t
        new_rot = torch.where(can[:, None, None], cr, new_rot)
        new_t = torch.where(can[:, None], ct, new_t)
        corrected = corrected | can
    # points: optimised ones directly, others via their reference KF:
    # X_new = T_r_new^-1 T_r_now X
    opt_pt = scatter_set(torch.zeros((ms.m_max,), dtype=torch.bool,
                                     device=in_win.device), mp_idx, mp_in)
    pos = scatter_set(ms.mp_pos, mp_idx, torch.where(
        mp_in[:, None], out.pts, ms.mp_pos[mp_idx]))
    ref = torch.clamp(ms.mp_first_kf.long(), 0, k - 1)
    pc = torch.einsum("mij,mj->mi", ms.kf_rot[ref], ms.mp_pos) + ms.kf_t[ref]
    pw = torch.einsum("mji,mj->mi", new_rot[ref], pc - new_t[ref])
    move = ms.mp_valid & ~opt_pt & corrected[ref]
    pos = torch.where(move[:, None], pw, pos)
    return ms._replace(
        kf_rot=torch.where(corrected[:, None, None], new_rot, ms.kf_rot),
        kf_t=torch.where(corrected[:, None], new_t, ms.kf_t),
        mp_pos=pos)


def _fuse_into(ms: M.MapState, center_kf: int, kf, enabled,
               cfg: MappingConfig, radius_px: float = 3.0) -> M.MapState:
    """Fuse the centre KF's map points into duplicates observed by `kf`:
    project, match by descriptor within radius_px, relabel the newer slot
    onto the older one everywhere (MapPoint::Replace)."""
    obs_c = ms.kf_obs_mp[center_kf]
    mp = torch.clamp_min(obs_c, 0).long()
    rot, t = ms.kf_rot[kf], ms.kf_t[kf]
    pc = ms.mp_pos[mp] @ rot.T + t
    z = torch.where(torch.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
    u = cfg.fx * pc[:, 0] / z + cfg.cx
    v = cfg.fy * pc[:, 1] / z + cfg.cy
    inb = (z > 0.1) & (u >= 0) & (u < 2 * cfg.cx) & (v >= 0) \
        & (v < 2 * cfg.cy)
    q_valid = (obs_c >= 0) & inb & ms.kf_valid[kf]
    radius = torch.full((obs_c.shape[0],), radius_px, device=z.device)
    m_idx, _ = matching.search_by_projection(
        torch.stack([u, v], dim=1), torch.zeros_like(obs_c), q_valid,
        ms.mp_desc[mp], ms.kf_uv[kf], ms.kf_level[kf], ms.kf_desc[kf],
        ms.kf_kp_valid[kf], radius, max_dist=TH_LOW)
    other = ms.kf_obs_mp[kf][torch.clamp_min(m_idx, 0).long()].long()
    dup = (m_idx >= 0) & (other >= 0) & (other != mp) & enabled
    keep = torch.where(other < mp, other, mp)
    drop = torch.where(other < mp, mp, other)
    m = ms.m_max
    relabel = torch.arange(m, dtype=torch.int32, device=z.device)
    relabel = scatter_set(relabel, torch.where(dup, drop, m),
                          torch.where(dup, keep, 0).to(torch.int32))
    obs_all = ms.kf_obs_mp
    new_obs_all = torch.where(obs_all >= 0,
                              relabel[torch.clamp_min(obs_all, 0).long()],
                              obs_all)
    dead = torch.zeros((m + 1,), dtype=torch.bool, device=z.device)
    dead[torch.where(dup, drop, m)] = True
    return ms._replace(kf_obs_mp=new_obs_all, mp_valid=ms.mp_valid & ~dead[:m])


def fuse_duplicates(ms: M.MapState, center_kf: int, cfg: MappingConfig,
                    cov=None) -> M.MapState:
    """SearchInNeighbors: fuse the centre KF's points into the five best
    covisible KFs of the same map (zero-weight filler neighbours skipped)."""
    if cov is None:
        cov = M.covisibility(ms)
    row = cov[center_kf] * ms.kf_valid \
        * (ms.kf_map_id == ms.kf_map_id[center_kf])
    w_nb, nb = topk_stable(row, 5)
    for i in range(5):
        ms = _fuse_into(ms, center_kf, nb[i], w_nb[i] > 0, cfg)
    return ms


def fuse_pair(ms: M.MapState, kf_a: int, kf_b: int,
              cfg: MappingConfig) -> M.MapState:
    """Loop SearchAndFuse: after a loop or merge correction, weld the two
    loop ends by fusing duplicates both ways with a wide radius (the
    corrected poses overlap but share no observations yet)."""
    enabled = ms.kf_valid[kf_a] & ms.kf_valid[kf_b] & (kf_a != kf_b)
    ms = _fuse_into(ms, kf_a, kf_b, enabled, cfg, radius_px=6.0)
    return _fuse_into(ms, kf_b, kf_a, enabled, cfg, radius_px=6.0)


def refresh_point_stats(ms: M.MapState, center_kf: int, n_window: int = 10,
                        cov=None) -> M.MapState:
    """ComputeDistinctiveDescriptors + UpdateNormalAndDepth for the centre
    KF's points, over its `n_window` best covisible KFs: the descriptor with
    the least median Hamming distance to the others, and the mean unit
    viewing direction."""
    if cov is None:
        cov = M.covisibility(ms)
    dev = ms.kf_valid.device
    row = (cov[center_kf] * ms.kf_valid).clone()
    row[center_kf] = 1 << 20
    _, kf_win = topk_stable(row, min(n_window, ms.k_max))       # [W]
    w = kf_win.shape[0]
    m = ms.m_max

    obs_c = ms.kf_obs_mp[center_kf]
    mp = torch.clamp_min(obs_c, 0).long()
    has = (obs_c >= 0) & ms.kf_kp_valid[center_kf] & ms.mp_valid[mp]
    n = obs_c.shape[0]

    # invert each window KF's observations: mp -> kp index
    o = ms.kf_obs_mp[kf_win].long()                              # [W, N]
    ok = (o >= 0) & ms.kf_kp_valid[kf_win]
    inv_all = torch.full((w, m), -1, dtype=torch.long, device=dev)
    rows = torch.arange(w, device=dev)[:, None].expand(w, n)
    kp_ids = torch.arange(n, device=dev)[None, :].expand(w, n)
    inv_all = scatter_set_2d(inv_all, rows, torch.where(ok, o, m), kp_ids)
    kp_idx = inv_all[:, mp]                                      # [W, N]
    seen = (kp_idx >= 0) & ms.kf_valid[kf_win][:, None]

    descs = ms.kf_desc[kf_win[:, None], torch.clamp_min(kp_idx, 0)]  # [W,N,8]
    dm = _batched_hamming(descs.transpose(0, 1))                 # [N, W, W]
    big = 1 << 10
    seen_t = seen.T                                              # [N, W]
    pair_ok = seen_t[:, :, None] & seen_t[:, None, :]
    dmm = torch.where(pair_ok, dm, big)
    srt = torch.sort(dmm, dim=2).values
    n_obs = seen_t.sum(dim=1)
    mid = torch.clamp_min(n_obs // 2, 1)
    med = torch.gather(srt, 2, mid[:, None, None].expand(n, w, 1))[:, :, 0]
    med = torch.where(seen_t, med, big)
    best_w = torch.argmin(med, dim=1)
    new_desc = descs[best_w, torch.arange(n, device=dev)]

    centers = -torch.einsum("wji,wj->wi", ms.kf_rot[kf_win], ms.kf_t[kf_win])
    d = ms.mp_pos[mp][None, :, :] - centers[:, None, :]
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-6)
    nsum = torch.sum(torch.where(seen[:, :, None], d, 0.0), dim=0)
    new_norm = nsum / torch.clamp_min(
        torch.linalg.norm(nsum, dim=-1, keepdim=True), 1e-6)

    tgt = torch.where(has & (n_obs >= 2), mp, m)
    return ms._replace(mp_desc=scatter_set(ms.mp_desc, tgt, new_desc),
                       mp_normal=scatter_set(ms.mp_normal, tgt, new_norm))


# ---------------------------------------------------------------------------
# Monocular triangulation of new points (CreateNewMapPoints)
# ---------------------------------------------------------------------------

def triangulate_new_points(ms: M.MapState, center_kf: int,
                           cfg: MappingConfig, max_new: int = 256,
                           n_neighbors: int = 3):
    """Match the centre KF's unbound keypoints against its `n_neighbors`
    best covisible KFs in turn and triangulate (the reference unrolls the
    top few of CreateNewMapPoints' 10-20). The neighbours are the top of
    cov[centre] * kf_valid, ties to the lowest slot: with fewer KFs than
    neighbours, slots that share nothing (the centre itself, empty or
    culled slots) come as they are. Each search binds points that the next
    one's free mask reads, so the three run one after another.
    Returns (ms, points made)."""
    row = M.covisibility(ms)[center_kf] * ms.kf_valid
    _, nbs = topk_stable(row, n_neighbors)
    total = torch.zeros((), dtype=torch.long, device=row.device)
    for i in range(n_neighbors):
        ms, n_new = _triangulate_with(ms, center_kf, nbs[i], cfg, max_new)
        total = total + n_new
    return ms, total


def _triangulate_with(ms: M.MapState, center_kf: int, nb: torch.Tensor,
                      cfg: MappingConfig, max_new: int):
    """New points from the centre KF and one neighbour `nb` (a 0-d slot
    tensor): the mutual match of their free keypoints, triangulated in the
    centre camera; kept with both reprojections under 2 px, depth in
    (0.1, 50) and parallax (baseline / depth) over 0.01, at most `max_new`,
    lowest keypoint first; bound in both KFs. Returns (ms, points made)."""
    n = ms.n_kp
    dev = ms.kf_valid.device
    free_c = ms.kf_kp_valid[center_kf] & (ms.kf_obs_mp[center_kf] == M.NO_MP)
    free_n = ms.kf_kp_valid[nb] & (ms.kf_obs_mp[nb] == M.NO_MP)
    m_idx, _ = matching.match_descriptors(
        ms.kf_desc[center_kf], free_c, ms.kf_desc[nb], free_n,
        max_dist=TH_LOW, ratio=0.8, mutual=True)

    def rays(uv):
        return torch.stack([(uv[:, 0] - cfg.cx) / cfg.fx,
                            (uv[:, 1] - cfg.cy) / cfg.fy,
                            torch.ones_like(uv[:, 0])], dim=1)

    rays_c = rays(ms.kf_uv[center_kf])
    rays_n = rays(ms.kf_uv[nb][torch.clamp_min(m_idx, 0).long()])
    # T_nc = T_n T_c^-1: the centre camera is the reference frame
    rci, tci = lie.se3_inverse(ms.kf_rot[center_kf], ms.kf_t[center_kf])
    r_nc, t_nc = lie.se3_compose(ms.kf_rot[nb], ms.kf_t[nb], rci, tci)
    pts_c, tri_ok = triangulate_points_f64(rays_c, rays_n, r_nc, t_nc)

    def reproj_err(r, pts):
        z = torch.where(torch.abs(pts[:, 2]) < 1e-6, 1e-6, pts[:, 2])
        return torch.linalg.norm(pts[:, :2] / z[:, None] - r[:, :2],
                                 dim=1) * cfg.fx

    e1 = reproj_err(rays_c, pts_c)
    e2 = reproj_err(rays_n, pts_c @ r_nc.T + t_nc)
    baseline = torch.linalg.norm(t_nc)
    good = ((m_idx >= 0) & tri_ok & (e1 < 2.0) & (e2 < 2.0)
            & (pts_c[:, 2] > 0.1) & (pts_c[:, 2] < 50.0)
            & (baseline / torch.clamp_min(pts_c[:, 2], 1e-3) > 0.01))
    pts_w = pts_c @ rci.T + tci
    # the cap, as the reference ranks it: good first, then by index
    _, order = topk_stable(
        good.float() - 1e-3 * torch.arange(n, dtype=torch.float32,
                                           device=dev), max_new)
    sel = torch.zeros((n,), dtype=torch.bool, device=dev)
    sel[order] = True
    make = good & sel

    ms, mp_slots = M.free_mp_slots(ms, n, use_mask=make)
    new_ids = torch.where(make, mp_slots, M.NO_MP).to(torch.int32)
    d = pts_w - tci
    dist = torch.linalg.norm(d, dim=1)
    normal = d / torch.clamp_min(dist[:, None], 1e-6)
    max_d = dist * cfg.scale_factor ** ms.kf_level[center_kf].float()
    min_d = max_d / (cfg.scale_factor ** 7)
    ms = M.add_map_points(ms, mp_slots, pts_w, ms.kf_desc[center_kf], normal,
                          min_d, max_d, center_kf, make)
    obs = ms.kf_obs_mp
    obs = M._set_row(obs, center_kf,
                     torch.where(make, new_ids, obs[center_kf]))
    tgt = torch.where(make & (m_idx >= 0), m_idx.long(), n)
    obs = M._set_row(obs, nb, scatter_set(obs[nb], tgt, new_ids))
    return ms._replace(kf_obs_mp=obs), make.sum()


def _batched_hamming(descs: torch.Tensor) -> torch.Tensor:
    """[N, W, 8] -> [N, W, W] Hamming distances (hamming_matrix per row)."""
    nn, w, _ = descs.shape
    pm = matching.unpack_bits_pm1(descs.reshape(nn * w, 8)).reshape(nn, w, 256)
    return ((256.0 - pm @ pm.transpose(1, 2)) * 0.5).to(torch.int32)


class VIWindow(NamedTuple):
    """A temporal KF window for VI-BA: slots oldest first, end-padded with
    k_max up to the window size (kw 8, 16 for VIBA1/VIBA2, 10 at the IMU
    initialization); segment i joins slots i and i+1. `icp` holds the
    segments' EdgeICP factors with use_icp."""
    slots: torch.Tensor        # [KW] long
    slot_valid: torch.Tensor   # [KW] bool
    segs: VIBA.ImuSegments
    r_cb: torch.Tensor         # [3, 3]
    t_cb: torch.Tensor         # [3]
    walk_info: torch.Tensor    # [6, 6]
    icp: Optional[VIBA.RelPoseFactors] = None


def vi_ba_step(ms: M.MapState, win: VIWindow, cfg: MappingConfig):
    """LocalInertialBA over a temporal window, its oldest KF fixed (the
    glue around solvers/inertial_ba.vi_local_ba). Returns (ms, number of
    BA observations)."""
    kw = win.slots.shape[0]
    fixed = torch.zeros((kw,), dtype=torch.bool, device=win.slots.device)
    fixed[0] = True
    prob_vis, mp_idx, mp_in, ctx = extract_ba_problem(
        ms, win.slots, win.slot_valid, fixed, cfg)
    kr = _clamped(ms, win.slots)
    prob = VIBA.VIBAProblem(
        vis=prob_vis, kf_vel=ms.kf_vel[kr], kf_bias=ms.kf_bias[kr],
        segs=win.segs, r_cb=win.r_cb, t_cb=win.t_cb,
        walk_info=win.walk_info, icp=win.icp)
    out, obs_inl = VIBA.vi_local_ba(prob, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                    cfg.bf)
    ms = writeback_ba(ms, out.vis, obs_inl, win.slots, win.slot_valid,
                      fixed, mp_idx, mp_in, ctx)
    upd = (win.slot_valid & ~fixed)[:, None]
    ms = ms._replace(
        kf_vel=scatter_set(ms.kf_vel, win.slots, torch.where(
            upd, out.kf_vel, ms.kf_vel[kr])),
        kf_bias=scatter_set(ms.kf_bias, win.slots, torch.where(
            upd, out.kf_bias, ms.kf_bias[kr])))
    return ms, prob_vis.obs_valid.sum()


def mapping_step(ms: M.MapState, frame, rot, t, time_rel: float, obs_mp,
                 ref_kf: int, kf_slot: int, tcfg: TrackConfig,
                 cfg: MappingConfig, vi=None):
    """The per-KF mapping pipeline (LocalMapping::Run body). With `vi`
    (velocity [3], bias [6], VIWindow) the new KF takes the body state's
    velocity and bias and VI-BA over the window replaces the local BA.

    Returns (ms, new_obs [N], local masks, kf_rot, kf_t, culled slot [],
    BA observation count [])."""
    ms, _ = T.create_keyframe(ms, frame, rot, t, time_rel, obs_mp, ref_kf,
                              kf_slot, tcfg)
    if vi is None:
        ms, n_obs = local_ba_step(ms, kf_slot, cfg)
    else:
        vel, bias, win = vi
        ms = ms._replace(kf_vel=M._set_row(ms.kf_vel, kf_slot, vel),
                         kf_bias=M._set_row(ms.kf_bias, kf_slot, bias))
        ms, n_obs = vi_ba_step(ms, win, cfg)
    # one post-BA incidence/covisibility shared by fusion, refresh and the
    # culls; neighbour selection may lag fusion's relabels by one step, as
    # in the reference, while every decision is masked by current validity
    inc2 = M.observation_incidence(ms)
    cov2 = M.covisibility(ms, incidence=inc2)
    ms = fuse_duplicates(ms, kf_slot, cfg, cov=cov2)
    ms = refresh_point_stats(ms, kf_slot, cov=cov2)
    ms = M.cull_map_points(ms, incidence=inc2)
    ms, culled = keyframe_culling(ms, kf_slot, incidence=inc2)
    obs = ms.kf_obs_mp[kf_slot]
    new_obs = torch.where((obs >= 0) & ms.mp_valid[torch.clamp_min(obs, 0)
                                                   .long()], obs, M.NO_MP)
    masks = M.local_window(ms, kf_slot, tcfg.local_window,
                           tcfg.lm_max_candidates, incidence=inc2)
    return (ms, new_obs, masks, ms.kf_rot[kf_slot], ms.kf_t[kf_slot], culled,
            n_obs)
