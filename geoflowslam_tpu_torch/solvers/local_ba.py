"""Local bundle adjustment: Gauss-Newton with a Schur complement (port of
geoflowslam_tpu/solvers/local_ba.py).

The observation structure is a dense [K, M] grid (keyframe x landmark) with
a validity mask. Landmarks are eliminated through their batched 3x3 blocks,
the reduced [6K, 6K] camera system is solved densely, fixed keyframes keep
their residuals but not their state rows. Two stages, as the reference:
5 iterations with the Huber kernel, chi-square re-gating, 10 without.
Inverses and solves use the *_ex variants (no host sync on singular
blocks); non-finite steps are dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.solvers.pose_opt import (CHI2_MONO, CHI2_STEREO,
                                                    HUBER_MONO, HUBER_STEREO,
                                                    huber_w)


class BAProblem(NamedTuple):
    """Dense local-BA problem, K keyframes x M landmarks (padded)."""
    kf_rot: torch.Tensor      # [K,3,3] Tcw rotation
    kf_t: torch.Tensor        # [K,3]
    kf_fixed: torch.Tensor    # [K] bool: contribute obs, not optimized
    kf_valid: torch.Tensor    # [K] bool
    pts: torch.Tensor         # [M,3] world
    pt_valid: torch.Tensor    # [M] bool
    uv: torch.Tensor          # [K,M,2]
    u_right: torch.Tensor     # [K,M]
    is_stereo: torch.Tensor   # [K,M] bool
    inv_sigma2: torch.Tensor  # [K,M]
    obs_valid: torch.Tensor   # [K,M] bool


def residuals(prob: BAProblem, fx, fy, cx, cy, bf):
    """r [K,M,3], jac_pose [K,M,3,6], jac_pt [K,M,3,3], behind [K,M]."""
    pc = torch.einsum("kij,mj->kmi", prob.kf_rot, prob.pts) \
        + prob.kf_t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    r = torch.stack([prob.uv[..., 0] - u, prob.uv[..., 1] - v,
                     torch.where(prob.is_stereo, prob.u_right - ur, 0.0)],
                    dim=-1)
    zero = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * inv_z2], dim=-1)
    d_proj = torch.stack([du, dv, dur], dim=-2)                  # [K,M,3,3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    d_pc_pose = torch.cat([eye, -lie.hat(pc)], dim=-1)           # [K,M,3,6]
    jac_pose = -torch.einsum("kmij,kmjl->kmil", d_proj, d_pc_pose)
    jac_pt = -torch.einsum("kmij,kjl->kmil", d_proj, prob.kf_rot)
    return r, jac_pose, jac_pt, z <= 0


def chi2(r, prob: BAProblem):
    r2 = r[..., 0] ** 2 + r[..., 1] ** 2 + torch.where(prob.is_stereo,
                                                       r[..., 2] ** 2, 0.0)
    return r2 * prob.inv_sigma2


def _gn_step(prob: BAProblem, active, fx, fy, cx, cy, bf, use_huber,
             damping=1e-6):
    r, jp, jl, behind = residuals(prob, fx, fy, cx, cy, bf)
    c2 = chi2(r, prob)
    delta = torch.where(prob.is_stereo, HUBER_STEREO, HUBER_MONO)
    w = huber_w(c2, delta) if use_huber else torch.ones_like(c2)
    w = w * prob.inv_sigma2 * (active & ~behind).float()
    row_mask = torch.stack([torch.ones_like(w), torch.ones_like(w),
                            prob.is_stereo.float()], dim=-1)
    wr = w[..., None] * row_mask                                  # [K,M,3]

    k, m = w.shape
    dev = w.device
    hpp = torch.einsum("kmri,kmr,kmrj->kij", jp, wr, jp)          # [K,6,6]
    hll = torch.einsum("kmri,kmr,kmrj->mij", jl, wr, jl)          # [M,3,3]
    hpl = torch.einsum("kmri,kmr,kmrj->kmij", jp, wr, jl)         # [K,M,6,3]
    bp = -torch.einsum("kmri,kmr->ki", jp, wr * r)                # [K,6]
    bl = -torch.einsum("kmri,kmr->mi", jl, wr * r)                # [M,3]

    # landmark elimination with trace-relative damping
    eye3 = torch.eye(3, dtype=hll.dtype, device=dev)
    tr = torch.diagonal(hll, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    hll = hll + (1e-3 * tr / 3.0 + damping) * eye3
    hll_inv, _ = torch.linalg.inv_ex(hll)
    pt_active = (torch.sum(w, dim=0) > 0) & prob.pt_valid
    hll_inv = hll_inv * pt_active[:, None, None]

    s = -torch.einsum("kmij,mjl,qmrl->kiqr", hpl, hll_inv, hpl)  # [K,6,K,6]
    ar = torch.arange(k, device=dev)
    s[ar, :, ar, :] = s[ar, :, ar, :] + hpp
    rhs = bp - torch.einsum("kmij,mjl,ml->ki", hpl, hll_inv, bl)

    free = (prob.kf_valid & ~prob.kf_fixed).float()               # [K]
    fm = free[:, None]
    s = s * fm[:, :, None, None] * free[None, None, :, None]
    sd = s.reshape(k * 6, k * 6)
    diag_fix = (1.0 - fm * torch.ones((k, 6), device=dev)).reshape(-1)
    sd = sd + torch.diag(diag_fix + 1e-3 * torch.diagonal(sd)) \
        + damping * torch.eye(k * 6, device=dev)
    rhs = (rhs * fm).reshape(-1)

    dp, _ = torch.linalg.solve_ex(sd, rhs)
    dp = dp.reshape(k, 6) * fm
    dp = torch.where(torch.all(torch.isfinite(dp)), dp, 0.0)
    dl = torch.einsum("mij,mj->mi", hll_inv,
                      bl - torch.einsum("kmij,ki->mj", hpl, dp))
    dl = torch.where(torch.all(torch.isfinite(dl)), dl, 0.0)

    dr_rot, dr_t = lie.se3_exp(dp)
    new_rot = lie.normalize_rotation(
        torch.einsum("kij,kjl->kil", dr_rot, prob.kf_rot))
    new_t = torch.einsum("kij,kj->ki", dr_rot, prob.kf_t) + dr_t
    new_pts = prob.pts + dl * pt_active[:, None]
    return prob._replace(kf_rot=new_rot, kf_t=new_t, pts=new_pts)


def local_bundle_adjustment(prob: BAProblem, fx, fy, cx, cy, bf=0.0,
                            iters1: int = 5, iters2: int = 10):
    """Two-stage local BA with outlier re-gating.
    Returns (problem, observation inlier mask [K, M])."""
    active = prob.obs_valid & prob.pt_valid[None, :] & prob.kf_valid[:, None]
    for _ in range(iters1):
        prob = _gn_step(prob, active, fx, fy, cx, cy, bf, True)
    r, _, _, behind = residuals(prob, fx, fy, cx, cy, bf)
    th = torch.where(prob.is_stereo, CHI2_STEREO, CHI2_MONO)
    active = active & (chi2(r, prob) <= th) & ~behind
    # the second stage drops the robust kernel after outlier pruning
    for _ in range(iters2):
        prob = _gn_step(prob, active, fx, fy, cx, cy, bf, False)
    r, _, _, behind = residuals(prob, fx, fy, cx, cy, bf)
    inliers = prob.obs_valid & (chi2(r, prob) <= th) & ~behind
    return prob, inliers
