"""Visual-inertial windowed bundle adjustment (port of
geoflowslam_tpu/solvers/inertial_ba.py; LocalInertialBA).

A temporal window of KF states (pose, velocity, gyro/acc bias: 15 DoF each)
is optimized jointly with the landmarks under reprojection, preintegrated
IMU and bias random-walk factors:
* the landmarks are eliminated by the dense Schur complement of
  solvers/local_ba.py (block-diagonal Hll);
* the reduced state system is dense [15K x 15K] (K <= 16), one
  Jacobi-scaled solve;
* the IMU factors' Jacobians are the closed forms of EdgeInertial
  (solvers/inertial.py), batched over the K-1 segments; the camera-pose
  Jacobians map to the body tangent through one constant 6x6 matrix.
With `icp` (RelPoseFactors, the inter-KF GICP measurements of use_icp)
each segment also carries an EdgeICP factor, e = log(T_meas^-1 T2 T1^-1)
in camera frames, weighted by info x I6 (a row with zero info is absent);
its Jacobians are the closed forms of `rel_pose_terms` (the SE(3) inverse
right Jacobian), mapped to the body tangent like the reprojection terms.
Steps are clamped per block (a trust region: near-rigid IMU information
overshoots from a far linearization point).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.solvers import inertial as VI
from geoflowslam_tpu_torch.solvers.local_ba import BAProblem, chi2, residuals
from geoflowslam_tpu_torch.solvers.pose_opt import (CHI2_MONO, CHI2_STEREO,
                                                    HUBER_MONO, HUBER_STEREO,
                                                    huber_w)


class ImuSegments(NamedTuple):
    """Stacked preintegration between consecutive window KFs i -> i+1."""
    dR: torch.Tensor         # [S, 3, 3]
    dV: torch.Tensor         # [S, 3]
    dP: torch.Tensor         # [S, 3]
    JRg: torch.Tensor        # [S, 3, 3]
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    info9: torch.Tensor      # [S, 9, 9] inverse preintegration covariance
    walk_info: torch.Tensor  # [S, 6, 6] inverse segment bias-walk covariance
    dt: torch.Tensor         # [S]
    bias0: torch.Tensor      # [S, 6] linearization bias
    valid: torch.Tensor      # [S] bool


class RelPoseFactors(NamedTuple):
    """EdgeICP relative-pose measurements between consecutive window KFs,
    T_meas = T_cw[i+1] T_cw[i]^-1 (camera frames)."""
    rot: torch.Tensor    # [S, 3, 3]
    t: torch.Tensor      # [S, 3]
    info: torch.Tensor   # [S] information weight (0: no factor)


class VIBAProblem(NamedTuple):
    vis: BAProblem           # poses Tcw + landmark/observation grid
    kf_vel: torch.Tensor     # [K, 3]
    kf_bias: torch.Tensor    # [K, 6]
    segs: ImuSegments        # K-1 temporal segments
    r_cb: torch.Tensor       # [3, 3] cam-from-body rotation
    t_cb: torch.Tensor       # [3]
    walk_info: torch.Tensor  # [6, 6] bias random-walk information
    icp: Optional[RelPoseFactors] = None   # EdgeICP factors


def rel_pose_terms(r1, t1, r2, t2, m_rot, m_t):
    """EdgeICP residual e = log(T_meas^-1 T2 T1^-1) [S, 6] and its Jacobians
    [S, 6, 6] in the left tangents [rho, phi] of the two camera poses
    (T' = exp(xi) T): -Jr^-1(e) for T1, and Jr^-1(-e) Ad(T_meas^-1) for T2
    (a left step of T2 is a left step Ad(T_meas^-1) xi of the error)."""
    ri, ti = lie.se3_inverse(r1, t1)
    rr, tr = lie.se3_compose(r2, t2, ri, ti)
    mi, mti = lie.se3_inverse(m_rot, m_t)
    e = lie.se3_log(*lie.se3_compose(mi, mti, rr, tr))
    j1 = -lie.se3_right_jacobian_inv(e)
    j2 = lie.se3_right_jacobian_inv(-e) @ lie.se3_adjoint(mi, mti)
    return e, j1, j2


def _states(rot_cw, t_cw, vel, bias, r_cb, t_cb):
    r_wb, p_wb = VI.body_from_cam(rot_cw, t_cw, r_cb, t_cb)
    return VI.BodyState(r_wb=r_wb, p=p_wb, v=vel, bg=bias[..., :3],
                        ba=bias[..., 3:])


def _segment_terms(states: VI.BodyState, segs: ImuSegments):
    """Residuals [S, 9] and Jacobians [S, 9, 15] of every segment's IMU
    factor in its two states' tangents (EdgeInertial, batched)."""
    p = VI.pre.Preintegrated(
        dt=segs.dt, dR=segs.dR, dV=segs.dV, dP=segs.dP, JRg=segs.JRg,
        JVg=segs.JVg, JVa=segs.JVa, JPg=segs.JPg, JPa=segs.JPa, cov=None,
        bias=segs.bias0, meas_acc=None, meas_gyro=None, meas_dt=None)
    return VI.inertial_residual_and_jacobians(
        VI.BodyState(*(x[:-1] for x in states)),
        VI.BodyState(*(x[1:] for x in states)), p)


def _apply_state_tangent(rot_cw, t_cw, vel, bias, d, r_cb, t_cb):
    """Body-tangent updates [K, 15] mapped back to the Tcw storage."""
    r_wb, p_wb = VI.body_from_cam(rot_cw, t_cw, r_cb, t_cb)
    r_wb = r_wb @ lie.so3_exp(d[:, 0:3])
    p_wb = p_wb + torch.einsum("kij,kj->ki", r_wb, d[:, 3:6])
    r_bw = r_wb.transpose(-1, -2)
    rot = r_cb @ r_bw
    t = torch.einsum("ij,kj->ki", r_cb,
                     -torch.einsum("kij,kj->ki", r_bw, p_wb)) + t_cb
    return rot, t, vel + d[:, 6:9], bias + d[:, 9:15]


def _clamp(seg, cap):
    n = torch.linalg.norm(seg, dim=-1, keepdim=True)
    return seg * torch.clamp(cap / torch.clamp_min(n, 1e-9), max=1.0)


def _gn_step(prob: VIBAProblem, vis: BAProblem, vel, bias, active, ad, fx,
             fy, cx, cy, bf, damping):
    k = vis.kf_rot.shape[0]
    dev, dtp = vis.kf_t.device, vis.kf_t.dtype
    r, jp_cam, jl, behind = residuals(vis, fx, fy, cx, cy, bf)
    c2 = chi2(r, vis)
    delta = torch.where(vis.is_stereo, HUBER_STEREO, HUBER_MONO)
    w = huber_w(c2, delta) * vis.inv_sigma2 * (active & ~behind).to(dtp)
    rm = torch.stack([torch.ones_like(w), torch.ones_like(w),
                      vis.is_stereo.to(w.dtype)], dim=-1)
    wr = w[..., None] * rm
    jp = torch.einsum("kmri,ij->kmrj", jp_cam, ad)            # body [dphi, dp]

    hpp6 = torch.einsum("kmri,kmr,kmrj->kij", jp, wr, jp)
    hll = torch.einsum("kmri,kmr,kmrj->mij", jl, wr, jl)
    hpl = torch.einsum("kmri,kmr,kmrj->kmij", jp, wr, jl)
    bp6 = -torch.einsum("kmri,kmr->ki", jp, wr * r)
    bl = -torch.einsum("kmri,kmr->mi", jl, wr * r)
    eye3 = torch.eye(3, dtype=dtp, device=dev)
    tr = torch.diagonal(hll, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    hll_inv, _ = torch.linalg.inv_ex(hll + (1e-3 * tr / 3.0 + damping)
                                     * eye3)
    pt_active = (torch.sum(w, dim=0) > 0) & vis.pt_valid
    hll_inv = hll_inv * pt_active[:, None, None]
    s6 = -torch.einsum("kmij,mjl,qmrl->kiqr", hpl, hll_inv, hpl)
    ar = torch.arange(k, device=dev)
    s6[ar, :, ar, :] = s6[ar, :, ar, :] + hpp6
    rhs6 = bp6 - torch.einsum("kmij,mjl,ml->ki", hpl, hll_inv, bl)

    d = 15
    s = torch.zeros((k, d, k, d), dtype=dtp, device=dev)
    s[:, :6, :, :6] = s6
    rhs = torch.zeros((k, d), dtype=dtp, device=dev)
    rhs[:, :6] = rhs6

    # IMU and bias-walk factors between consecutive KFs
    e_in, j1, j2 = _segment_terms(
        _states(vis.kf_rot, vis.kf_t, vel, bias, prob.r_cb, prob.t_cb),
        prob.segs)
    wseg = prob.segs.valid.to(dtp)[:, None, None]
    info9 = prob.segs.info9 * wseg
    winfo = prob.segs.walk_info * wseg
    e_bw = bias[1:] - bias[:-1]
    h11 = j1.transpose(1, 2) @ info9 @ j1
    h22 = j2.transpose(1, 2) @ info9 @ j2
    h12 = j1.transpose(1, 2) @ info9 @ j2
    g1 = -(j1.transpose(1, 2) @ (info9 @ e_in[..., None]))[..., 0]
    g2 = -(j2.transpose(1, 2) @ (info9 @ e_in[..., None]))[..., 0]
    # the bias walk's Jacobians are -I and +I on the two states' bias rows
    wbw = (winfo @ e_bw[..., None])[..., 0]
    h11[:, 9:, 9:] += winfo
    h22[:, 9:, 9:] += winfo
    h12[:, 9:, 9:] -= winfo
    g1[:, 9:] += wbw
    g2[:, 9:] -= wbw
    if prob.icp is not None:
        # EdgeICP on the pose rows [dphi, dp] of the body tangent
        e_c, j1c, j2c = rel_pose_terms(vis.kf_rot[:-1], vis.kf_t[:-1],
                                       vis.kf_rot[1:], vis.kf_t[1:],
                                       prob.icp.rot, prob.icp.t)
        j1c, j2c = j1c @ ad, j2c @ ad
        wi = (prob.icp.info * prob.segs.valid.to(dtp))[:, None, None]
        h11[:, :6, :6] += wi * (j1c.transpose(1, 2) @ j1c)
        h22[:, :6, :6] += wi * (j2c.transpose(1, 2) @ j2c)
        h12[:, :6, :6] += wi * (j1c.transpose(1, 2) @ j2c)
        we = wi * e_c[..., None]
        g1[:, :6] -= (j1c.transpose(1, 2) @ we)[..., 0]
        g2[:, :6] -= (j2c.transpose(1, 2) @ we)[..., 0]
    ii = torch.arange(k - 1, device=dev)
    s[ii, :, ii, :] = s[ii, :, ii, :] + h11
    s[ii + 1, :, ii + 1, :] = s[ii + 1, :, ii + 1, :] + h22
    s[ii, :, ii + 1, :] = s[ii, :, ii + 1, :] + h12
    s[ii + 1, :, ii, :] = s[ii + 1, :, ii, :] + h12.transpose(-1, -2)
    rhs = rhs.index_add(0, ii, g1).index_add(0, ii + 1, g2)

    # fixed and padded KFs keep their rows out of the system
    free = (vis.kf_valid & ~vis.kf_fixed).to(dtp)
    fm = free[:, None]
    s = s * fm[:, :, None, None] * free[None, None, :, None]
    sd = s.reshape(k * d, k * d)
    diag_fix = (1.0 - fm * torch.ones((k, d), dtype=dtp, device=dev)
                ).reshape(-1)
    sd = sd + torch.diag(diag_fix + 1e-3 * torch.diagonal(sd)) \
        + damping * torch.eye(k * d, dtype=dtp, device=dev)
    dx = VI._scaled_solve(sd, (rhs * fm).reshape(-1)).reshape(k, d) * fm
    dx = torch.cat([_clamp(dx[:, 0:3], 0.2), _clamp(dx[:, 3:6], 0.5),
                    _clamp(dx[:, 6:9], 1.0), _clamp(dx[:, 9:15], 0.05)], 1)

    dl = torch.einsum("mij,mj->mi", hll_inv,
                      bl - torch.einsum("kmij,ki->mj", hpl, dx[:, :6]))
    dl = torch.where(torch.all(torch.isfinite(dl)), dl, 0.0)
    new_rot, new_t, new_vel, new_bias = _apply_state_tangent(
        vis.kf_rot, vis.kf_t, vel, bias, dx, prob.r_cb, prob.t_cb)
    vis2 = vis._replace(kf_rot=lie.normalize_rotation(new_rot), kf_t=new_t,
                        pts=vis.pts + dl * pt_active[:, None])
    return vis2, new_vel, new_bias


def vi_local_ba(prob: VIBAProblem, fx, fy, cx, cy, bf=0.0, iters1: int = 4,
                iters2: int = 6, damping: float = 1e-5):
    """Joint GN over the [K, 15] states and the landmarks, Huber kernel in
    both stages, chi-square re-gating between them. Returns (problem with
    the optimized states and points, observation inlier mask [K, M])."""
    vis, vel, bias = prob.vis, prob.kf_vel, prob.kf_bias
    active = vis.obs_valid & vis.pt_valid[None, :] & vis.kf_valid[:, None]
    ad = VI.cam_from_body_tangent(prob.r_cb, prob.t_cb)
    th = torch.where(vis.is_stereo, CHI2_STEREO, CHI2_MONO)
    for stage, n_iters in enumerate((iters1, iters2)):
        if stage == 1:
            r, _, _, behind = residuals(vis, fx, fy, cx, cy, bf)
            active = active & (chi2(r, vis) <= th) & ~behind
        for _ in range(n_iters):
            vis, vel, bias = _gn_step(prob, vis, vel, bias, active, ad, fx,
                                      fy, cx, cy, bf, damping)
    r, _, _, behind = residuals(vis, fx, fy, cx, cy, bf)
    inliers = vis.obs_valid & (chi2(r, vis) <= th) & ~behind
    return prob._replace(vis=vis, kf_vel=vel, kf_bias=bias), inliers
