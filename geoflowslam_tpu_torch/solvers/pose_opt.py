"""Pose-only optimization: Gauss-Newton with IRLS Huber weights (port of
geoflowslam_tpu/solvers/pose_opt.py with its point-to-plane term).

Optimizer::PoseOptimization semantics: 4 rounds x 10 GN iterations with
chi-square re-gating between rounds (chi2 mono 5.991, stereo 7.815; outliers
may re-enter), the Huber kernel in all but the last round, left-
multiplicative se3 updates on Tcw. The 6x6 solve uses solve_ex so that a
singular system costs no host sync; a non-finite step is dropped. With
`plane_obs` every iteration adds the point-to-plane factors of the lidar
stage (EdgeLidarPoint2Plane, Huber 0.1 m).

The reference's `PosePrior` (a quadratic pose prior fused in an extra GN
pass) is not ported: no caller on its paths passes one; its staged ICP
predictor builds a prior only to flag an ICP-carried frame.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.math import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = math.sqrt(CHI2_MONO)
HUBER_STEREO = math.sqrt(CHI2_STEREO)


class PoseObs(NamedTuple):
    """Padded reprojection observation set for one frame."""
    pts_w: torch.Tensor       # [N, 3] map point world positions
    uv: torch.Tensor          # [N, 2] observed pixels
    u_right: torch.Tensor     # [N] right-cam u for RGB-D obs
    is_stereo: torch.Tensor   # [N] bool
    inv_sigma2: torch.Tensor  # [N] information weight (per octave)
    valid: torch.Tensor       # [N] bool


class PlaneObs(NamedTuple):
    """Point-to-plane observations: residual n . (T_wc p_c) + d."""
    pts_c: torch.Tensor    # [L, 3] camera-frame points
    normal: torch.Tensor   # [L, 3] world plane normals
    d: torch.Tensor        # [L] plane offsets
    valid: torch.Tensor    # [L] bool


def plane_terms(rot, t, pl: PlaneObs, huber: float = 0.1):
    """(H [6, 6], g [6], r [L]) of the point-to-plane factors under IRLS
    Huber weights; p_w = R_cw^T (p_c - t_cw), and the left update on Tcw
    gives d p_w / d[rho, phi] = R_wc [-I | hat(p_c)]."""
    pw = (pl.pts_c - t) @ rot
    r = torch.sum(pl.normal * pw, dim=1) + pl.d
    n_c = pl.normal @ rot.T
    jac = torch.cat([-n_c, torch.linalg.cross(n_c, pl.pts_c)], dim=1)
    w = torch.where(torch.abs(r) <= huber, 1.0,
                    huber / torch.clamp_min(torch.abs(r), 1e-9))
    w = w * pl.valid.to(r.dtype)
    h = torch.einsum("l,li,lj->ij", w, jac, jac)
    g = -torch.einsum("l,li,l->i", w, jac, r)
    return h, g, r


def reproj_residuals(rot, t, obs: PoseObs, fx, fy, cx, cy, bf):
    """Residuals r [N,3] (u, v, u_r), Jacobians [N,3,6] wrt [rho, phi] and
    the behind-camera mask. Mono rows leave the third component zero."""
    pc = obs.pts_w @ rot.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    r = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                     torch.where(obs.is_stereo, obs.u_right - ur, 0.0)], dim=1)
    zero = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=1)
    d_proj = torch.stack([du, dv, dur], dim=1)                 # [N,3,3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[0], 3, 3)
    d_pc = torch.cat([eye, -lie.hat(pc)], dim=2)               # [N,3,6]
    jac = -torch.einsum("nij,njk->nik", d_proj, d_pc)
    return r, jac, z <= 0


def _chi2(r, obs: PoseObs):
    r2 = r[:, 0] ** 2 + r[:, 1] ** 2 + torch.where(obs.is_stereo,
                                                   r[:, 2] ** 2, 0.0)
    return r2 * obs.inv_sigma2


def huber_w(chi2, delta):
    """IRLS weight of the Huber kernel at sqrt-chi2 scale delta."""
    s = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(s <= delta, 1.0, delta / s)


def pose_optimization(rot0, t0, obs: PoseObs, fx, fy, cx, cy, bf=0.0,
                      plane_obs: Optional[PlaneObs] = None,
                      rounds: int = 4, iters_per_round: int = 10,
                      min_obs_for_update: int = 3):
    """Pose-only GN, with the point-to-plane factors of `plane_obs` in every
    iteration. Returns (rot, t, inlier mask [N], n_inliers [] int)."""
    inlier = obs.valid
    row_mask = torch.stack([torch.ones_like(obs.inv_sigma2),
                            torch.ones_like(obs.inv_sigma2),
                            obs.is_stereo.float()], dim=1)
    delta = torch.where(obs.is_stereo, HUBER_STEREO, HUBER_MONO)
    th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    eye6 = torch.eye(6, dtype=rot0.dtype, device=rot0.device)
    rot, t = rot0, t0
    for rnd in range(rounds):
        use_huber = rnd < rounds - 1
        for _ in range(iters_per_round):
            r, jac, behind = reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
            chi2 = _chi2(r, obs)
            w = huber_w(chi2, delta) if use_huber else torch.ones_like(chi2)
            act = inlier & ~behind
            w = w * obs.inv_sigma2 * act.float()
            wr = w[:, None] * row_mask
            h = torch.einsum("nri,nr,nrj->ij", jac, wr, jac)
            g = -torch.einsum("nri,nr->i", jac, wr * r)
            if plane_obs is not None:
                hp, gp, _ = plane_terms(rot, t, plane_obs)
                h, g = h + hp, g + gp
            h = h + 1e-6 * eye6
            dx, _ = torch.linalg.solve_ex(h, g)
            ok = ((act.sum() >= min_obs_for_update)
                  & torch.all(torch.isfinite(dx)))
            dx = torch.where(ok, dx, 0.0)
            dr, dt = lie.se3_exp(dx)
            rot2, t = lie.se3_compose(dr, dt, rot, t)
            rot = lie.normalize_rotation(rot2)
        r, _, behind = reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
        inlier = obs.valid & (_chi2(r, obs) <= th) & ~behind
    return rot, t, inlier, inlier.sum()
