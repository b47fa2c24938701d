"""Visual-inertial pose optimization of the current frame (port of the
tracking part of geoflowslam_tpu/solvers/inertial.py).

* `inertial_pose_optimization`: PoseInertialOptimizationLastKeyFrame. GN
  over the current body state (pose, velocity, gyro/acc bias) against the
  last state, which is held fixed, through the preintegrated IMU factor
  (EdgeInertial), the bias random walk and the reprojection terms; it also
  returns the state's information at the solution, the prior of the next
  frame.
* `inertial_pose_optimization_joint`: PoseInertialOptimizationLastFrame.
  Joint GN over the previous state, held only by its marginalized prior
  (EdgePriorPoseImu), and the current one; the previous state is then
  marginalized by a Schur complement.

State: world-from-body pose (R_wb, p_wb), velocity v_w and bias (bg, ba),
updated by the right-multiplicative 15-dim tangent of `apply_tangent`.
The Jacobians are the closed forms of ORB-SLAM3's EdgeInertial and
EdgePriorPoseImu in that tangent (the reference takes them by forward-mode
AD). The fixed `rounds` x `iters` loop reads nothing on the host: the
solves are Jacobi-scaled `solve_ex`, a non-finite step is dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.imu import preintegration as pre
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.math.sym_eig import eigh_jacobi
from geoflowslam_tpu_torch.solvers.pose_opt import (CHI2_MONO, CHI2_STEREO,
                                                    HUBER_MONO, HUBER_STEREO,
                                                    PoseObs, _chi2, huber_w,
                                                    reproj_residuals)


class BodyState(NamedTuple):
    r_wb: torch.Tensor   # [3, 3]
    p: torch.Tensor      # [3]
    v: torch.Tensor      # [3]
    bg: torch.Tensor     # [3]
    ba: torch.Tensor     # [3]


def apply_tangent(s: BodyState, d: torch.Tensor) -> BodyState:
    """Right-multiplicative 15-dim update [dphi, dp, dv, dbg, dba]
    (ImuCamPose::Update)."""
    return BodyState(r_wb=s.r_wb @ lie.so3_exp(d[0:3]),
                     p=s.p + s.r_wb @ d[3:6], v=s.v + d[6:9],
                     bg=s.bg + d[9:12], ba=s.ba + d[12:15])


def cam_pose_from_body(s: BodyState, r_cb, t_cb):
    """T_cw = T_cb T_bw."""
    r_bw = s.r_wb.T
    return r_cb @ r_bw, r_cb @ (-r_bw @ s.p) + t_cb


def body_from_cam(rot_cw, t_cw, r_cb, t_cb):
    """(R_wb, p_wb) of T_wb = T_wc T_cb, batched over leading dims."""
    r_wc = rot_cw.transpose(-1, -2)
    t_wc = -torch.einsum("...ij,...j->...i", r_wc, t_cw)
    return r_wc @ r_cb, torch.einsum("...ij,j->...i", r_wc, t_cb) + t_wc


def cam_from_body_tangent(r_cb, t_cb) -> torch.Tensor:
    """[6, 6]: the camera pose's left tangent [rho, phi] per body tangent
    [dphi, dp] (T_cw' = exp(xi) T_cw with xi = -Ad(T_cb) [dp; dphi]); the
    same for every pose."""
    ad = torch.zeros((6, 6), dtype=r_cb.dtype, device=r_cb.device)
    ad[0:3, 0:3] = -lie.hat(t_cb) @ r_cb
    ad[0:3, 3:6] = -r_cb
    ad[3:6, 0:3] = -r_cb
    return ad


def _blocks(rows):
    """Assemble a matrix from rows of [..., 3, 3] blocks."""
    return torch.cat([torch.cat(row, -1) for row in rows], -2)


def inertial_residual(s1: BodyState, s2: BodyState, p: pre.Preintegrated):
    """EdgeInertial's 9-dim residual [er, ev, ep] with s1's bias through the
    preintegration's bias Jacobians."""
    return inertial_residual_and_jacobians(s1, s2, p)[0]


def inertial_residual_and_jacobians(s1: BodyState, s2: BodyState,
                                    p: pre.Preintegrated):
    """EdgeInertial: residual [..., 9] and its Jacobians [..., 9, 15] in
    s1's and s2's tangents (G2oTypes.cc EdgeInertial::linearizeOplus),
    batched over leading dims."""
    g = pre.gravity(s1.p)
    dt = p.dt[..., None]
    bias = torch.cat([s1.bg, s1.ba], -1)
    d_r = pre.delta_rotation(p, bias)
    d_v = pre.delta_velocity(p, bias)
    d_p = pre.delta_position(p, bias)
    phi_b = pre.mv(p.JRg, s1.bg - p.bias[..., :3])   # the gyro-bias increment
    r1t = s1.r_wb.transpose(-1, -2)
    e_rot = d_r.transpose(-1, -2) @ r1t @ s2.r_wb
    er = lie.so3_log(e_rot)
    dv_w = s2.v - s1.v - g * dt
    dp_w = s2.p - s1.p - s1.v * dt - 0.5 * g * dt * dt
    dv_b, dp_b = pre.mv(r1t, dv_w), pre.mv(r1t, dp_w)
    ev, ep = dv_b - d_v, dp_b - d_p
    jr_inv = lie.so3_right_jacobian_inv(er)
    z = torch.zeros_like(r1t)
    eye = torch.eye(3, dtype=er.dtype, device=er.device).expand(z.shape)
    j1 = _blocks([
        [-jr_inv @ s2.r_wb.transpose(-1, -2) @ s1.r_wb, z, z,
         -jr_inv @ e_rot.transpose(-1, -2) @ lie.so3_right_jacobian(phi_b)
         @ p.JRg, z],
        [lie.hat(dv_b), z, -r1t, -p.JVg, -p.JVa],
        [lie.hat(dp_b), -eye, -r1t * dt[..., None], -p.JPg, -p.JPa]])
    j2 = _blocks([[jr_inv, z, z, z, z],
                  [z, z, r1t, z, z],
                  [z, r1t @ s2.r_wb, z, z, z]])
    return torch.cat([er, ev, ep], -1), j1, j2


def prior_tangent(s: BodyState, mean: BodyState):
    """EdgePriorPoseImu: the 15-dim right tangent of s relative to the
    prior mean, and its Jacobian [15, 15] in s's tangent."""
    rel = mean.r_wb.T @ s.r_wb
    dr = lie.so3_log(rel)
    r = torch.cat([dr, mean.r_wb.T @ (s.p - mean.p), s.v - mean.v,
                   s.bg - mean.bg, s.ba - mean.ba])
    j = torch.eye(15, dtype=r.dtype, device=r.device)
    j[0:3, 0:3] = lie.so3_right_jacobian_inv(dr)
    j[3:6, 3:6] = rel
    return r, j


def bias_walk(s1: BodyState, s2: BodyState):
    """Bias random-walk residual [6] (s2's bias minus s1's)."""
    return torch.cat([s2.bg - s1.bg, s2.ba - s1.ba])


def _reproj_body(s: BodyState, obs: PoseObs, r_cb, t_cb, ad, fx, fy, cx,
                 cy, bf):
    """Reprojection residuals [N, 3], their Jacobians [N, 3, 6] in the body
    tangent's [dphi, dp] and the depths."""
    rot, t = cam_pose_from_body(s, r_cb, t_cb)
    r, jac, _ = reproj_residuals(rot, t, obs, fx, fy, cx, cy, bf)
    z = obs.pts_w @ rot[2] + t[2]
    return r, jac @ ad, z


def _obs_weights(r, z, obs: PoseObs, inlier, use_huber: bool):
    chi2 = _chi2(r, obs)
    delta = torch.where(obs.is_stereo, HUBER_STEREO, HUBER_MONO)
    w = huber_w(chi2, delta) if use_huber else torch.ones_like(chi2)
    w = w * obs.inv_sigma2 * (inlier & (z > 0)).to(r.dtype)
    rm = torch.stack([torch.ones_like(w), torch.ones_like(w),
                      obs.is_stereo.to(w.dtype)], 1)
    return w[:, None] * rm


def _regate(r, z, obs: PoseObs):
    th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    return obs.valid & (_chi2(r, obs) <= th) & (z > 0)


def _scaled_solve(h, g):
    """Jacobi-preconditioned solve: the blocks span ~1e2 (reprojection) to
    ~1e8 (IMU, bias); unscaled float32 solves lose the small ones."""
    dj = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(h), 1e-12))
    dx, _ = torch.linalg.solve_ex(h * dj[:, None] * dj[None, :], dj * g)
    dx = dj * dx
    return torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)


def _damp(h):
    n = h.shape[0]
    return (h + 1e-3 * torch.diag(torch.diagonal(h))
            + 1e-5 * torch.eye(n, dtype=h.dtype, device=h.device))


def _imu_information(p: pre.Preintegrated):
    """Information of the IMU factor (cov[:9, :9] + 1e-6 I)^-1, symmetrized,
    and of the segment's bias walk (cov[9:, 9:] + 1e-10 I)^-1."""
    eye9 = torch.eye(9, dtype=p.cov.dtype, device=p.cov.device)
    info9, _ = torch.linalg.inv_ex(p.cov[:9, :9] + 1e-6 * eye9)
    info9 = 0.5 * (info9 + info9.T)
    eye6 = torch.eye(6, dtype=p.cov.dtype, device=p.cov.device)
    walk, _ = torch.linalg.inv_ex(p.cov[9:15, 9:15] + 1e-10 * eye6)
    return info9, walk


def _add_quadratic(h, g, jac, info, r):
    return h + jac.T @ info @ jac, g - jac.T @ (info @ r)


def inertial_pose_optimization(s2: BodyState, s1: BodyState,
                               preint: pre.Preintegrated, obs: PoseObs, r_cb,
                               t_cb, fx, fy, cx, cy, bf=0.0, rounds: int = 4,
                               iters: int = 10, return_info: bool = False):
    """Optimize the current body state s2; s1 (the last KF's) is fixed.
    `rounds` of `iters` GN steps with chi-square re-gating between rounds,
    the Huber kernel in all but the last. Returns (s2, inlier mask,
    n_inliers), plus the 15x15 information of s2 at the solution when
    return_info."""
    info9, walk_info = _imu_information(preint)
    ad = cam_from_body_tangent(r_cb, t_cb)
    j_bw = torch.zeros((6, 15), dtype=info9.dtype, device=info9.device)
    j_bw[:, 9:15] = torch.eye(6, dtype=info9.dtype, device=info9.device)

    def system(s, inlier, use_huber):
        r_re, jb, z = _reproj_body(s, obs, r_cb, t_cb, ad, fx, fy, cx, cy, bf)
        wr = _obs_weights(r_re, z, obs, inlier, use_huber)
        h = r_re.new_zeros((15, 15))
        g = r_re.new_zeros(15)
        h[:6, :6] = torch.einsum("nri,nr,nrj->ij", jb, wr, jb)
        g[:6] = -torch.einsum("nri,nr->i", jb, wr * r_re)
        r_in, _, j_in = inertial_residual_and_jacobians(s1, s, preint)
        h, g = _add_quadratic(h, g, j_in, info9, r_in)
        return _add_quadratic(h, g, j_bw, walk_info, bias_walk(s1, s))

    inlier = obs.valid
    for rnd in range(rounds):
        for _ in range(iters):
            h, g = system(s2, inlier, rnd < rounds - 1)
            s2 = apply_tangent(s2, _scaled_solve(_damp(h), g))
        r_re, _, z = _reproj_body(s2, obs, r_cb, t_cb, ad, fx, fy, cx, cy,
                                  bf)
        inlier = _regate(r_re, z, obs)
    s2 = s2._replace(r_wb=lie.normalize_rotation(s2.r_wb))
    if not return_info:
        return s2, inlier, inlier.sum()
    # s2's information at the solution: inlier reprojections (no robust
    # kernel), the IMU factor and the bias walk (Optimizer.cc:6334+)
    info, _ = system(s2, inlier, False)
    return s2, inlier, inlier.sum(), sanitize_info(info)


def sanitize_info(info: torch.Tensor) -> torch.Tensor:
    """Symmetrize and clamp a marginal information matrix to PSD (float32
    Schur complements can go slightly indefinite); zeros if not finite.
    The eigendecomposition is a fixed-sweep Jacobi in float64
    (math/sym_eig.eigh_jacobi): `torch.linalg.eigh` waits for the device on
    CUDA."""
    info = 0.5 * (info + info.T)
    ev, vec = eigh_jacobi(info.to(torch.float64))
    info = ((vec * torch.clamp_min(ev, 0.0)[None, :]) @ vec.T).to(info.dtype)
    return torch.where(torch.all(torch.isfinite(info)), info, 0.0)


def inertial_pose_optimization_joint(s2: BodyState, s1: BodyState,
                                     prior_info, preint: pre.Preintegrated,
                                     obs: PoseObs, r_cb, t_cb, fx, fy, cx,
                                     cy, bf=0.0, rounds: int = 4,
                                     iters: int = 6):
    """Joint GN over the previous frame's state s1 (held by its marginalized
    prior `prior_info` around its own value) and the current s2, then s1
    marginalized out: H22 - H21 H11^-1 H12 at the solution, inlier weights,
    no robust kernel. Returns (s2, inlier mask, n_inliers, marginal
    information [15, 15])."""
    info9, walk_info = _imu_information(preint)
    ad = cam_from_body_tangent(r_cb, t_cb)
    dev, dt = info9.device, info9.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    j_bw = torch.zeros((6, 30), dtype=dt, device=dev)
    j_bw[:, 9:15] = -eye6
    j_bw[:, 24:30] = eye6
    s1_bar = s1

    def system(s1c, s2c, inlier, use_huber):
        r_re, jb, z = _reproj_body(s2c, obs, r_cb, t_cb, ad, fx, fy, cx, cy,
                                   bf)
        wr = _obs_weights(r_re, z, obs, inlier, use_huber)
        h = r_re.new_zeros((30, 30))
        g = r_re.new_zeros(30)
        h[15:21, 15:21] = torch.einsum("nri,nr,nrj->ij", jb, wr, jb)
        g[15:21] = -torch.einsum("nri,nr->i", jb, wr * r_re)
        r_in, j1, j2 = inertial_residual_and_jacobians(s1c, s2c, preint)
        h, g = _add_quadratic(h, g, torch.cat([j1, j2], 1), info9, r_in)
        h, g = _add_quadratic(h, g, j_bw, walk_info, bias_walk(s1c, s2c))
        r_pr, j_pr = prior_tangent(s1c, s1_bar)
        h[:15, :15] = h[:15, :15] + j_pr.T @ prior_info @ j_pr
        g[:15] = g[:15] - j_pr.T @ (prior_info @ r_pr)
        return h, g

    inlier = obs.valid
    for rnd in range(rounds):
        for _ in range(iters):
            h, g = system(s1, s2, inlier, rnd < rounds - 1)
            dx = _scaled_solve(_damp(h), g)
            s1, s2 = apply_tangent(s1, dx[:15]), apply_tangent(s2, dx[15:])
        r_re, _, z = _reproj_body(s2, obs, r_cb, t_cb, ad, fx, fy, cx, cy,
                                  bf)
        inlier = _regate(r_re, z, obs)
    h, _ = system(s1, s2, inlier, False)
    h = h + 1e-6 * torch.eye(30, dtype=dt, device=dev)
    h11, h12, h22 = h[:15, :15], h[:15, 15:], h[15:, 15:]
    dj = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(h11), 1e-12))
    x, _ = torch.linalg.solve_ex(h11 * dj[:, None] * dj[None, :],
                                 dj[:, None] * h12)
    marg = sanitize_info(h22 - h12.T @ (dj[:, None] * x))
    s2 = s2._replace(r_wb=lie.normalize_rotation(s2.r_wb))
    return s2, inlier, inlier.sum(), marg
