"""Batched RANSAC (port of geoflowslam_tpu/ops/ransac.py): a fixed batch
of hypotheses from minimal sets, each solved in closed form and scored over
all points at once.

* `ransac_fundamental` (8-point F) and `ransac_homography` (4-point DLT),
  with the reference's chi-square scoring, for the monocular initializer;
* `ransac_pnp` (6-point DLT) and `refine_pnp_ml` (MLPnP's bearing-vector GN),
  for relocalization;
* `solve_sim3_horn` and `ransac_sim3`, for loop verification.

Minimal sets are drawn by Gumbel top-k from an explicit torch.Generator;
ties go to the lowest index, as jax.lax.top_k breaks them. The draws cannot
equal jax.random's, so each RANSAC also takes the sets themselves
(`sample_sets`) and `_sample_minimal_sets` the Gumbel noise, for tests that
hand both packages the same draws. SVD sign choices do not reach a result:
every solver fixes the sign or uses sign-invariant products.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.math.sym_eig import (drop_smallest_singular3,
                                                null_vector, svd3)
from geoflowslam_tpu_torch.ops.indexing import topk_stable


class RansacResult(NamedTuple):
    model: torch.Tensor      # best model parameters
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int
    score: torch.Tensor      # [] float (model score)


def _sample_minimal_sets(gen: Optional[torch.Generator], valid: torch.Tensor,
                         n_hyp: int, set_size: int,
                         noise: Optional[torch.Tensor] = None):
    """[n_hyp, set_size] distinct indices drawn from the valid entries by
    per-hypothesis Gumbel top-k; `noise` [n_hyp, N] replaces the draw."""
    if noise is None:
        u = torch.rand((n_hyp, valid.shape[0]), generator=gen,
                       device=valid.device)
        noise = -torch.log(-torch.log(
            torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    g = torch.where(valid[None, :], noise, float("-inf"))
    return topk_stable(g, set_size)[1]


def _normalize_2d(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: zero mean, mean distance sqrt(2). Returns the
    normalized points and the 3x3 transform."""
    w = valid.to(pts.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    d = torch.linalg.norm(pts - mean, dim=1)
    md = torch.sum(d * w) / n
    s = (2.0 ** 0.5) / torch.clamp_min(md, 1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, zero, -s * mean[0]]),
                     torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, t


def _solve_f_8pt(p1: torch.Tensor, p2: torch.Tensor,
                 svd: bool = False) -> torch.Tensor:
    """8-point F from [K, 8, 2] x [K, 8, 2] normalized points, rank 2
    enforced. Returns [K, 3, 3]. The null vector and the rank-2 projection
    come from math/sym_eig (float64, no host sync; the frame step's OF
    stage), or with `svd` from float32 torch.linalg.svd as the reference
    takes them (it waits for the device on CUDA; the monocular initializer,
    see mono_init.two_view_reconstruct)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)            # [K, 8, 9]
    if not svd:
        return drop_smallest_singular3(null_vector(a).reshape(-1, 3, 3))
    vt = torch.linalg.svd(a, full_matrices=True)[2]
    u, s, vt2 = torch.linalg.svd(vt[..., 8, :].reshape(-1, 3, 3))
    s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], dim=1)
    return u @ torch.diag_embed(s) @ vt2


def _epipolar_dist2(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Squared epipolar transfer distances (image 1, image 2), pixels^2, of
    [N] point pairs under [K, 3, 3] models -> two [K, N]."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    h1 = torch.cat([p1, ones], dim=1)
    h2 = torch.cat([p2, ones], dim=1)
    l2 = h1 @ f.transpose(-1, -2)       # epilines in image 2, [K, N, 3]
    l1 = h2 @ f                         # epilines in image 1
    num = torch.sum(h2 * l2, dim=-1) ** 2
    d2 = num / torch.clamp_min(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d1 = num / torch.clamp_min(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    return d1, d2


def ransac_fundamental(gen: Optional[torch.Generator], uv1: torch.Tensor,
                       uv2: torch.Tensor, valid: torch.Tensor,
                       n_hyp: int = 128, threshold: float = 3.84,
                       sigma: float = 1.0,
                       sample_sets: Optional[torch.Tensor] = None,
                       svd: bool = False) -> RansacResult:
    """F-RANSAC with TwoViewReconstruction::CheckFundamental's scoring:
    per point th_score - chi2 for chi2 < threshold * sigma^2, both
    directions. `sample_sets` [n_hyp, 8] replaces the draw from `gen`;
    `svd` solves the hypotheses with torch.linalg.svd (_solve_f_8pt)."""
    uv1n, t1 = _normalize_2d(uv1, valid)
    uv2n, t2 = _normalize_2d(uv2, valid)
    idx = (sample_sets if sample_sets is not None
           else _sample_minimal_sets(gen, valid, n_hyp, 8))
    fs_n = _solve_f_8pt(uv1n[idx], uv2n[idx], svd)
    fs = t2.T @ fs_n @ t1                       # F = T2^T Fn T1
    th = threshold * sigma * sigma
    th_score = 5.991 * sigma * sigma
    d1, d2 = _epipolar_dist2(fs, uv1, uv2)
    in1 = (d1 < th) & valid
    in2 = (d2 < th) & valid
    inls = in1 & in2
    scores = torch.sum(torch.where(in1, th_score - d1, 0.0)
                       + torch.where(in2, th_score - d2, 0.0), dim=1)
    return _best(fs, inls, scores)


def _best(models, inls, scores) -> RansacResult:
    """The hypothesis with the highest score (the first on ties), selected
    on the device."""
    best = torch.argmax(scores).reshape(1)
    inl = inls.index_select(0, best)[0]
    return RansacResult(models.index_select(0, best)[0], inl,
                        torch.sum(inl), scores.index_select(0, best)[0])


# ---------------------------------------------------------------------------
# Homography (4-point DLT)
# ---------------------------------------------------------------------------

def _solve_h_4pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Homographies from [K, 4, 2] x [K, 4, 2] point sets (p2 ~ H p1), the
    null vector of the 8 x 9 DLT system scaled to H[2, 2] = 1 (which also
    fixes the SVD's sign). Returns [K, 3, 3] in the points' dtype.

    The system is solved in float64: on pixel coordinates it is too
    ill-conditioned for float32, where LAPACK (the reference's path, and
    torch's on the CPU) and cuSOLVER land ~1e-3 from the exact solution,
    each elsewhere; in float64 the CPU and the card agree."""
    dtype = p1.dtype
    p1, p2 = p1.double(), p2.double()
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = torch.stack([r1, r2], dim=-2).reshape(*p1.shape[:-2], 8, 9)
    vt = torch.linalg.svd(a, full_matrices=True)[2]
    h = vt[..., 8, :].reshape(*p1.shape[:-2], 3, 3)
    h22 = h[..., 2:3, 2:3]
    return (h / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)).to(dtype)


def _h_transfer_dist2(h: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Squared symmetric transfer distances of [N] point pairs under
    [K, 3, 3] homographies: (|H^-1 p2 - p1|^2, |H p1 - p2|^2), two [K, N]."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    h1 = torch.cat([p1, ones], dim=1)
    h2 = torch.cat([p2, ones], dim=1)

    def dehom(q):
        w = q[..., 2:3]
        return q[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)

    q2 = dehom(h1 @ h.transpose(-1, -2))
    q1 = dehom(h2 @ torch.linalg.inv(h).transpose(-1, -2))
    return (torch.sum((q1 - p1) ** 2, dim=-1),
            torch.sum((q2 - p2) ** 2, dim=-1))


def ransac_homography(gen: Optional[torch.Generator], uv1: torch.Tensor,
                      uv2: torch.Tensor, valid: torch.Tensor,
                      n_hyp: int = 128, sigma: float = 1.0,
                      sample_sets: Optional[torch.Tensor] = None
                      ) -> RansacResult:
    """H-RANSAC with TwoViewReconstruction::CheckHomography's scoring: per
    point th - chi2 for chi2 < th = 5.991 sigma^2, both directions.
    `sample_sets` [n_hyp, 4] replaces the draw from `gen`."""
    idx = (sample_sets if sample_sets is not None
           else _sample_minimal_sets(gen, valid, n_hyp, 4))
    hs = _solve_h_4pt(uv1[idx], uv2[idx])
    th = 5.991 * sigma * sigma
    d12, d21 = _h_transfer_dist2(hs, uv1, uv2)
    in1 = (d12 < th) & valid
    in2 = (d21 < th) & valid
    inls = in1 & in2
    scores = torch.sum(torch.where(in1, th - d12, 0.0)
                       + torch.where(in2, th - d21, 0.0), dim=1)
    best = torch.argmax(scores)
    return RansacResult(hs[best], inls[best], torch.sum(inls[best]),
                        scores[best])


# ---------------------------------------------------------------------------
# PnP (6-point DLT + orthogonalisation) and its ML refinement
# ---------------------------------------------------------------------------

def _solve_pnp_dlt(pts3d: torch.Tensor, rays: torch.Tensor):
    """[H, 6, 3] world points + [H, 6, 2] normalised image coords ->
    (R [H, 3, 3], t [H, 3]) camera <- world."""
    x, y = rays[..., 0], rays[..., 1]
    ph = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)
    zeros = torch.zeros_like(ph)
    a = torch.cat([torch.cat([ph, zeros, -x[..., None] * ph], dim=-1),
                   torch.cat([zeros, ph, -y[..., None] * ph], dim=-1)],
                  dim=-2)                                       # [H, 12, 12]
    p = null_vector(a).reshape(-1, 3, 4)
    # sign: points must have positive depth on average
    depths = torch.einsum("hnj,hj->hn", ph, p[:, 2])
    p = p * torch.where(depths.sum(-1) < 0, -1.0, 1.0)[:, None, None]
    u, sv, vt2 = svd3(p[:, :, :3])
    det = torch.linalg.det(u @ vt2)
    dvec = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    rot = u @ torch.diag_embed(dvec) @ vt2
    scale = torch.sum(sv * dvec, dim=-1) / 3.0
    return rot, p[:, :, 3] / torch.clamp_min(scale, 1e-12)[:, None]


def ransac_pnp(gen: Optional[torch.Generator], pts3d: torch.Tensor,
               uv_norm: torch.Tensor, valid: torch.Tensor, n_hyp: int = 128,
               threshold_px: float = 5.99, focal: float = 1.0,
               sample_sets: Optional[torch.Tensor] = None) -> RansacResult:
    """PnP RANSAC over normalised image coords, the threshold in pixels via
    `focal`. Returns model [3, 4] = [R|t]."""
    idx = (sample_sets if sample_sets is not None
           else _sample_minimal_sets(gen, valid, n_hyp, 6))
    rots, ts = _solve_pnp_dlt(pts3d[idx], uv_norm[idx])
    pc = torch.einsum("nj,hij->hni", pts3d, rots) + ts[:, None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    err2 = torch.sum((proj - uv_norm) ** 2, dim=-1) * focal * focal
    inls = (err2 < threshold_px ** 2) & (z > 0) & valid
    models = torch.cat([rots, ts[:, :, None]], dim=2)
    return _best(models, inls, inls.float().sum(dim=1))


def refine_pnp_ml(rot0, t0, pts3d, uv_norm, inliers, iters: int = 8):
    """Maximum-likelihood PnP refinement over bearing vectors
    (MLPnPsolver::mlpnp_gn): Gauss-Newton on each observed bearing's
    residual in its own 2D nullspace basis, r_i = [r_i; s_i]^T u_i with
    u_i = (R p_i + t) / |R p_i + t|, left-multiplicative se3 updates."""
    v = torch.cat([uv_norm, torch.ones_like(uv_norm[:, :1])], dim=1)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    e = torch.where(torch.abs(v[:, 2:3]) < 0.9, eye[2], eye[0])
    r_b = torch.linalg.cross(v, e)
    r_b = r_b / torch.clamp_min(torch.linalg.norm(r_b, dim=1, keepdim=True),
                                1e-9)
    s_b = torch.linalg.cross(v, r_b)
    w = inliers.float()
    eye = torch.eye(3, device=v.device)
    rot, t = rot0, t0
    for _ in range(iters):
        pc = pts3d @ rot.T + t
        nrm = torch.clamp_min(torch.linalg.norm(pc, dim=1, keepdim=True),
                              1e-9)
        u = pc / nrm
        res = torch.stack([torch.sum(r_b * u, dim=1),
                           torch.sum(s_b * u, dim=1)], dim=1)
        du = (eye[None] - u[:, :, None] * u[:, None, :]) / nrm[:, :, None]
        dpc = torch.cat([eye.expand(pc.shape[0], 3, 3), -lie.hat(pc)], dim=2)
        jac_u = du @ dpc                                        # [N, 3, 6]
        jac = torch.stack([torch.einsum("ni,nik->nk", r_b, jac_u),
                           torch.einsum("ni,nik->nk", s_b, jac_u)], dim=1)
        h = torch.einsum("n,nri,nrj->ij", w, jac, jac) \
            + 1e-8 * torch.eye(6, device=v.device)
        g = torch.einsum("n,nri,nr->i", w, jac, res)
        dx = -torch.linalg.solve_ex(h, g)[0]
        dr = lie.so3_exp(dx[3:])
        rot, t = dr @ rot, dr @ t + dx[:3]
    return rot, t


# ---------------------------------------------------------------------------
# Sim3 (Horn closed form, 3 points)
# ---------------------------------------------------------------------------

def solve_sim3_horn(pts1: torch.Tensor, pts2: torch.Tensor, w=None,
                    fix_scale: bool = False):
    """Closed-form Sim3 aligning pts1 -> pts2 ([..., N, 3] each, optional
    weights [..., N]), Horn's method as in Sim3Solver::ComputeSim3.
    Returns (s, R, t) with pts2 ~= s R pts1 + t."""
    if w is None:
        w = torch.ones(pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    wn = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
    c1 = torch.sum(pts1 * wn[..., None], dim=-2)
    c2 = torch.sum(pts2 * wn[..., None], dim=-2)
    q1 = pts1 - c1[..., None, :]
    q2 = pts2 - c2[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, q2, q1)
    u, sv, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    dvec = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    rot = u @ torch.diag_embed(dvec) @ vt
    var1 = torch.sum(wn * torch.sum(q1 * q1, dim=-1), dim=-1)
    scale = (torch.ones_like(var1) if fix_scale
             else torch.sum(sv * dvec, dim=-1) / torch.clamp_min(var1, 1e-12))
    t = c2 - scale[..., None] * torch.einsum("...ij,...j->...i", rot, c1)
    return scale, rot, t


def ransac_sim3(gen: Optional[torch.Generator], pts1: torch.Tensor,
                pts2: torch.Tensor, valid: torch.Tensor, n_hyp: int = 64,
                threshold: float = 0.05, fix_scale: bool = False,
                sample_sets: Optional[torch.Tensor] = None) -> RansacResult:
    """Sim3 RANSAC over 3D-3D correspondences; the threshold is a relative
    3D distance (a fraction of the point's depth). Returns model [13] =
    [s, R (row-major), t]."""
    idx = (sample_sets if sample_sets is not None
           else _sample_minimal_sets(gen, valid, n_hyp, 3))
    ss, rots, ts = solve_sim3_horn(pts1[idx], pts2[idx], fix_scale=fix_scale)
    pred = ss[:, None, None] * torch.einsum("nj,hij->hni", pts1, rots) \
        + ts[:, None, :]
    err = torch.linalg.norm(pred - pts2, dim=-1)
    rel = err / torch.clamp_min(torch.linalg.norm(pts2, dim=-1), 1e-6)
    inls = (rel < threshold) & valid
    best = torch.argmax(inls.float().sum(dim=1))
    model = torch.cat([ss[best][None], rots[best].reshape(-1), ts[best]])
    return RansacResult(model, inls[best], inls[best].sum(),
                        inls[best].float().sum())
