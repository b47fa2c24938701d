"""Trajectory error against the benchmark's ground truth, in NumPy; it
imports nothing of the program.

`umeyama_align` and `ate_rmse_m` are a frozen copy of geoflowslam_tpu_torch/
eval/ate.py's arithmetic (the reference's PoseEvaluator: Umeyama on the
positions, then the RMSE). `pose_errors` aligns whole poses instead: the
rotation that best maps the returned orientations onto the true ones
(chordal mean) and the translation of the mean, which a window of a few
metres of nearly straight motion pins down where positions alone do not;
it gives each frame's position and rotation error.
"""
from __future__ import annotations

import numpy as np


def umeyama_align(src, dst, with_scale=False):
    """Least-squares similarity/rigid transform aligning src -> dst [N, 3]."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    scale = (np.trace(np.diag(d) @ s) / ((xs ** 2).sum() / len(src))
             if with_scale else 1.0)
    return scale, rot, mu_d - scale * rot @ mu_s


def ate_rmse_m(est_twc, gt_twc) -> float:
    """ATE RMSE (m) of the positions after Umeyama's rigid alignment."""
    pe, pg = est_twc[:, :3, 3], gt_twc[:, :3, 3]
    _, rot, t = umeyama_align(pe, pg)
    return float(np.sqrt((((pe @ rot.T + t) - pg) ** 2).sum(axis=1).mean()))


def step_errors(est_twc, gt_twc):
    """Frame-to-frame errors (RPE over one frame, ate.py's `rpe` with
    delta 1, each interval kept): (translation m [N-1], rotation deg
    [N-1]) of inv(inv(gt_i) gt_i+1) inv(est_i) est_i+1."""
    est = np.asarray(est_twc, np.float64)
    gt = np.asarray(gt_twc, np.float64)
    de = np.linalg.inv(est[:-1]) @ est[1:]
    dg = np.linalg.inv(gt[:-1]) @ gt[1:]
    err = np.linalg.inv(dg) @ de
    cos = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    trans = np.linalg.norm(err[:, :3, 3], axis=1)
    rot = np.degrees(np.arccos(cos))
    bad = ~np.isfinite(err).all(axis=(1, 2))
    trans[bad] = rot[bad] = np.inf
    return trans, rot


def pose_align(est, gt):
    """(R, t) of the rigid map T that best takes est [N, 4, 4] onto gt:
    R from the SVD of sum R_gt R_est^T, t the mean of p_gt - R p_est."""
    m = np.einsum("nij,nkj->ik", gt[:, :3, :3], est[:, :3, :3])
    u, _, vt = np.linalg.svd(m)
    d = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
    rot = u @ d @ vt
    return rot, (gt[:, :3, 3] - est[:, :3, 3] @ rot.T).mean(axis=0)


def pose_errors(est_twc: np.ndarray, gt_twc: np.ndarray):
    """Per-frame (position error m [N], rotation error deg [N]) of est
    [N, 4, 4] against gt [N, 4, 4] after one rigid alignment of whole
    poses; non-finite poses read as infinite errors."""
    est = np.asarray(est_twc, np.float64)
    gt = np.asarray(gt_twc, np.float64)
    ok = np.isfinite(est).all(axis=(1, 2))
    pos_err = np.full(len(est), np.inf)
    rot_err = np.full(len(est), np.inf)
    if ok.sum() < 3:
        return pos_err, rot_err
    rot, t = pose_align(est[ok], gt[ok])
    p = est[:, :3, 3] @ rot.T + t
    pos_err[ok] = np.linalg.norm(p - gt[:, :3, 3], axis=1)[ok]
    r_rel = np.einsum("ij,njk,nlk->nil", rot, est[:, :3, :3], gt[:, :3, :3])
    cos = np.clip((np.trace(r_rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_err[ok] = np.degrees(np.arccos(cos))[ok]
    return pos_err, rot_err
