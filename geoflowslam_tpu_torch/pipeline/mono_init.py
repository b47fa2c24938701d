"""Monocular initialization: two-view reconstruction and the initial map
(port of geoflowslam_tpu/pipeline/mono_init.py).

Tracking::MonocularInitialization and CreateInitialMapMonocular with
TwoViewReconstruction: match the first two frames (one mutual ratio-0.9
search, both directions in one launch of the best-two Hamming kernel on the
card; optional GMS), score 128 F and 128 H hypotheses each (ops/ransac.py),
pick H when SH / (SH + SF) > 0.50, recover the motion among the
decomposition's candidates with cheirality and reprojection checks,
triangulate in camera 1, normalize the scale to median depth 1, and seed
the map with the two KFs and the points.

The SVD sign choices do not reach a result: a flip of a singular pair
permutes the candidate set of either decomposition (for H, (e1, e3) ->
(D0 e1, D2 e3); for E, r1 <-> r2), and a pose is chosen only when its
count of good points is unique (`n_second < 0.75 n_best`), so the winner
does not depend on the candidates' order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.config import TH_LOW
from geoflowslam_tpu_torch.math import triangulate
from geoflowslam_tpu_torch.ops import gms, matching, ransac
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import FrameData


class MonoInitResult(NamedTuple):
    ok: torch.Tensor          # [] bool
    rot21: torch.Tensor       # [3, 3] frame 2 from frame 1
    t21: torch.Tensor         # [3], scaled to median depth 1
    pts1: torch.Tensor        # [N, 3] triangulated points in camera 1
    match_idx: torch.Tensor   # [N] kp1 -> kp2 or -1
    pt_valid: torch.Tensor    # [N] bool
    use_h: torch.Tensor       # [] bool: the homography was chosen


def _decompose_essential(e_mat: torch.Tensor):
    """E -> the 4 candidate (R, t) (TwoViewReconstruction::DecomposeE)."""
    u, _, vt = torch.linalg.svd(e_mat)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = e_mat.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    return [(r1, t), (r1, -t), (r2, t), (r2, -t)]


def _decompose_homography(a_mat: torch.Tensor):
    """Calibrated homography A = K^-1 H K -> the 8 (R, t) motion hypotheses
    of Faugeras' SVD method (TwoViewReconstruction::ReconstructH), t of
    unit norm."""
    u, d, vt = torch.linalg.svd(a_mat)
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    eps = 1e-9
    den = torch.clamp_min(d1 * d1 - d3 * d3, eps)
    x1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / den, 0.0))
    x3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / den, 0.0))
    d2e = torch.clamp_min(d2, eps)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    out = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # d' = +d2
            st = (d1 - d3) * (e1 * x1) * (e3 * x3) / d2e
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2e
            rp = torch.stack([torch.stack([ct, zero, -st]),
                              torch.stack([zero, one, zero]),
                              torch.stack([st, zero, ct])])
            tp = torch.stack([e1 * x1, zero, -e3 * x3]) * (d1 - d3)
            t = u @ tp
            out.append((s * u @ rp @ vt,
                        t / torch.clamp_min(torch.linalg.norm(t), eps)))
            # d' = -d2
            sp = (d1 + d3) * (e1 * x1) * (e3 * x3) / d2e
            cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2e
            rp2 = torch.stack([torch.stack([cp, zero, sp]),
                               torch.stack([zero, -one, zero]),
                               torch.stack([sp, zero, -cp])])
            tp2 = torch.stack([e1 * x1, zero, e3 * x3]) * (d1 + d3)
            t2 = u @ tp2
            out.append((s * u @ rp2 @ vt,
                        t2 / torch.clamp_min(torch.linalg.norm(t2), eps)))
    return out


def _pick_best(cands, inl, rays1, rays2, fx: float, sigma: float):
    """Triangulate under every candidate and keep the one with the most
    good points (cheirality, inlier of its model, reprojection < 4 sigma
    px in both views): (ok, R, t, points, good), ok requiring more than 50
    good points and the second best count below 0.75 of the best."""
    counts, all_pts, all_good = [], [], []
    for rot, t in cands:
        pts, tri_ok = triangulate.triangulate_points_f64(rays1, rays2, rot,
                                                           t)
        e1 = torch.linalg.norm(
            pts[:, :2] / torch.clamp_min(pts[:, 2:3], 1e-6) - rays1[:, :2],
            dim=1) * fx
        pts2 = pts @ rot.T + t
        e2 = torch.linalg.norm(
            pts2[:, :2] / torch.clamp_min(pts2[:, 2:3], 1e-6) - rays2[:, :2],
            dim=1) * fx
        good = tri_ok & inl & (e1 < 4.0 * sigma) & (e2 < 4.0 * sigma)
        counts.append(good.sum())
        all_pts.append(pts)
        all_good.append(good)
    counts = torch.stack(counts)
    best = torch.argmax(counts)     # ties to the lowest index, as jnp.argmax
    n_best = counts[best]
    n_second = torch.sort(counts).values[-2]
    ok = (n_best > 50) & (n_second < 0.75 * n_best)
    rots = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return (ok, rots[best], ts[best], torch.stack(all_pts)[best],
            torch.stack(all_good)[best])


def two_view_reconstruct(gen: Optional[torch.Generator], uv1, uv2, valid,
                         fx, fy, cx, cy, n_hyp: int = 128,
                         sigma: float = 1.0):
    """H/F model selection, motion recovery and triangulation
    (TwoViewReconstruction::Reconstruct: SH / (SH + SF) > 0.50 takes the
    8-hypothesis homography decomposition, otherwise the 4-hypothesis
    essential one). The F sets are drawn first, then the H sets, from
    `gen`. Returns (ok, R21, t21 of unit norm, points in camera 1, good,
    use_h). The F hypotheses take the reference's float32 SVD: the
    initializer runs in the staged step, which reads the device anyway. The
    sync-free solve agrees with it to float32 rounding on the initializer's
    hypotheses (tests/test_torch_mono.py), but the monocular room at
    640x480 sits at its ATE gate, and that rounding, amplified through the
    initialization, moves it across (PERF.md §6)."""
    res_f = ransac.ransac_fundamental(gen, uv1, uv2, valid, n_hyp,
                                      sigma=sigma, svd=True)
    res_h = ransac.ransac_homography(gen, uv1, uv2, valid, n_hyp,
                                     sigma=sigma)
    use_h = res_h.score / torch.clamp_min(res_h.score + res_f.score,
                                          1e-9) > 0.50
    k_mat = uv1.new_tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    k_inv = torch.linalg.inv(k_mat)
    cands_f = _decompose_essential(k_mat.T @ res_f.model @ k_mat)
    cands_h = _decompose_homography(k_inv @ res_h.model @ k_mat)
    ones = torch.ones_like(uv1[:, :1])
    rays1 = torch.cat([uv1, ones], 1) @ k_inv.T
    rays2 = torch.cat([uv2, ones], 1) @ k_inv.T
    best_f = _pick_best(cands_f, res_f.inliers, rays1, rays2, fx, sigma)
    best_h = _pick_best(cands_h, res_h.inliers, rays1, rays2, fx, sigma)
    return tuple(torch.where(use_h, h, f) for f, h in zip(best_f, best_h)) \
        + (use_h,)


def _nanmedian(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Median of x[keep] with numpy's rule (the mean of the two middle
    values of an even count; torch.nanmedian takes the lower one), NaN when
    nothing is kept."""
    k = keep.sum()
    s = torch.sort(torch.where(keep, x, float("inf"))).values
    lo = s[torch.clamp_min(torch.div(k - 1, 2, rounding_mode="floor"), 0)]
    hi = s[torch.clamp_min(torch.div(k, 2, rounding_mode="floor"), 0)
           .clamp_max(x.shape[0] - 1)]
    return torch.where(k > 0, (lo + hi) * 0.5, float("nan"))


def try_monocular_init(gen: Optional[torch.Generator], frame1: FrameData,
                       frame2: FrameData, fx, fy, cx, cy,
                       min_matches: int = 100,
                       use_gms: bool = False) -> MonoInitResult:
    """Match frame1 <-> frame2 and attempt the reconstruction
    (SearchForInitialization, with `use_gms` the grid-motion-statistics
    pass of UseGMSInit): mutual ratio-0.9 matches within 100 px, at least
    `min_matches` of them, the scale normalized to median depth 1."""
    f1, f2 = frame1.feat, frame2.feat
    m_idx, _ = matching.match_descriptors(f1.desc, f1.valid, f2.desc,
                                          f2.valid, max_dist=TH_LOW,
                                          ratio=0.9, mutual=True)
    uv2 = f2.uv[torch.clamp_min(m_idx, 0).long()]
    near = torch.linalg.norm(uv2 - f1.uv, dim=1) < 100.0
    m_idx = torch.where(near, m_idx, -1)
    if use_gms:
        size = (int(2 * cx), int(2 * cy))
        m_idx = gms.gms_filter(f1.uv, f2.uv, m_idx, size, size)
    valid = m_idx >= 0
    ok, rot21, t21, pts1, good, use_h = two_view_reconstruct(
        gen, f1.uv, uv2, valid, fx, fy, cx, cy)
    ok = ok & (valid.sum() >= min_matches)
    med = _nanmedian(pts1[:, 2], good)
    # jnp.maximum propagates a NaN median, as torch.maximum does
    scale = 1.0 / torch.maximum(med, med.new_tensor(1e-6))
    return MonoInitResult(ok=ok, rot21=rot21, t21=t21 * scale,
                          pts1=pts1 * scale, match_idx=m_idx.to(torch.int32),
                          pt_valid=good, use_h=use_h)


def create_initial_map_mono(ms: M.MapState, frame1: FrameData,
                            frame2: FrameData, init: MonoInitResult,
                            time1: float, time2: float,
                            scale_factor: float = 1.2, n_levels: int = 8):
    """Insert KF1 (identity), then KF2 (R21, t21) in the next free slot,
    and the triangulated points (world = camera 1) observed by both.
    Returns (ms, slot1, slot2, frame 2's bindings, points made)."""
    f1, f2 = frame1.feat, frame2.feat
    n = f1.capacity
    dev = f1.uv.device
    slot1 = int(M.free_kf_slot(ms))
    make = init.pt_valid & (init.match_idx >= 0)
    ms, mp_slots = M.free_mp_slots(ms, n, use_mask=make)
    ids = torch.where(make, mp_slots, M.NO_MP).to(torch.int32)
    tgt = torch.where(make, init.match_idx.long(), n)
    obs2 = torch.full((n + 1,), M.NO_MP, dtype=torch.int32, device=dev)
    obs2[tgt] = ids          # distinct targets: the match is mutual
    obs2 = obs2[:n]
    no_depth = torch.full((n,), -1.0, device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    ms = M.insert_keyframe(ms, slot1, eye, zero, time1, f1.uv, f1.level,
                           f1.angle, f1.desc, no_depth, f1.valid, ids, -1)
    slot2 = int(M.free_kf_slot(ms))
    ms = M.insert_keyframe(ms, slot2, init.rot21, init.t21, time2, f2.uv,
                           f2.level, f2.angle, f2.desc, no_depth, f2.valid,
                           obs2, slot1)
    pts_w = init.pts1
    dist = torch.linalg.norm(pts_w, dim=1)
    normal = -pts_w / torch.clamp_min(dist[:, None], 1e-6)
    max_d = dist * scale_factor ** f1.level.float()
    min_d = max_d / (scale_factor ** (n_levels - 1))
    ms = M.add_map_points(ms, mp_slots, pts_w, f1.desc, normal, min_d, max_d,
                          slot1, make)
    return ms, slot1, slot2, obs2, make.sum()
