"""GICP and NDT point-cloud registration as fixed-iteration Gauss-Newton
(port of geoflowslam_tpu/ops/gicp.py).

Correspondences come from the brute-force kNN of ops/pointcloud.py over
downsampled padded clouds (P <= 4096); each iteration solves one 6x6 system
on SE(3) with masked correspondences. Solves and inverses use the `_ex`
forms, which do not synchronise with the host to check for errors; a
non-finite step is zeroed as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.ops import pointcloud as pc


class RegistrationResult(NamedTuple):
    rot: torch.Tensor        # [3, 3] target <- source
    t: torch.Tensor          # [3]
    n_inliers: torch.Tensor  # [] int (matched correspondences, last iter)
    error: torch.Tensor      # [] mean residual norm over inliers
    converged: torch.Tensor  # [] bool


def _inv_sym3(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form inverse (adjugate / det) of [P, 3, 3] symmetric
    matrices."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e = m[:, 1, 1], m[:, 1, 2]
    f = m[:, 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    rows = torch.stack([
        torch.stack([co00, co01, co02], dim=1),
        torch.stack([co01, co11, co12], dim=1),
        torch.stack([co02, co12, co22], dim=1),
    ], dim=1)
    return rows * inv_det[:, None, None]


def _gn_step(rot, t, ps, r, w, matched, damping: float):
    """One Gauss-Newton update of (rot, t) from residuals r [P, 3] with
    information w [P, 3, 3] at the transformed points ps; left-multiplied
    update, Jacobian [I | -hat(ps)]. Returns (rot, t, stats)."""
    dtype = ps.dtype
    eye3 = torch.eye(3, dtype=dtype, device=ps.device)
    jac = torch.cat([eye3.expand(ps.shape[0], 3, 3), -lie.hat(ps)], dim=2)
    jw = torch.einsum("pij,pik->pjk", jac, w)                  # [P, 6, 3]
    h = torch.einsum("pjk,pkl->jl", jw, jac)
    g = -torch.einsum("pjk,pk->j", jw, r)
    h = h + damping * torch.eye(6, dtype=dtype, device=ps.device)
    dx = torch.linalg.solve_ex(h, g)[0]
    dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
    dr, dt = lie.se3_exp(dx)
    rot2 = lie.normalize_rotation(dr @ rot)
    t2 = dr @ t + dt
    n = torch.sum(matched)
    err = (torch.sum(torch.linalg.norm(r, dim=1) * matched)
           / torch.clamp_min(n, 1))
    return rot2, t2, (n, err, torch.linalg.norm(dx))


def _result(rot, t, stats) -> RegistrationResult:
    n, err, dx_norm = stats
    return RegistrationResult(rot=rot, t=t, n_inliers=n.to(torch.int32),
                              error=err, converged=dx_norm < 1e-3)


def gicp_register(src: torch.Tensor, src_valid: torch.Tensor,
                  tgt: torch.Tensor, tgt_valid: torch.Tensor,
                  init_rot=None, init_t=None, max_corr_dist: float = 0.1,
                  iters: int = 10, k_cov: int = 10) -> RegistrationResult:
    """Generalized ICP (plane-to-plane), covariance-weighted GN over
    [P, 3] padded clouds. Returns T with tgt ~= R src + t."""
    dtype, dev = src.dtype, src.device
    rot = torch.eye(3, dtype=dtype, device=dev) if init_rot is None \
        else init_rot
    t = torch.zeros(3, dtype=dtype, device=dev) if init_t is None else init_t
    cov_s, _ = pc.estimate_covariances(src, src_valid, k_cov)
    cov_t, _ = pc.estimate_covariances(tgt, tgt_valid, k_cov)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    stats = None
    for _ in range(iters):
        ps = src @ rot.T + t
        idx, d2, ok = pc.knn_indices(ps, src_valid, tgt, tgt_valid, 1)
        nn = idx[:, 0]
        matched = ok[:, 0] & (d2[:, 0] < max_corr_dist * max_corr_dist)
        r = ps - tgt[nn]
        # GICP information: W = (C_t + R C_s R^T)^-1
        rcs = rot @ cov_s @ rot.T
        w = (_inv_sym3(cov_t[nn] + rcs + 1e-6 * eye3)
             * matched[:, None, None].to(dtype))
        rot, t, stats = _gn_step(rot, t, ps, r, w, matched, 1e-6)
    return _result(rot, t, stats)


def build_ndt_grid(tgt: torch.Tensor, tgt_valid: torch.Tensor,
                   resolution: float, max_voxels: int = 2048):
    """Voxel means and regularized inverse covariances of the target cloud
    (PCL-style: at least 5 points per voxel, eigenvalues floored at 1e-2 of
    the largest). Returns padded (centers [V, 3], cov_inv [V, 3, 3], valid
    [V]). The segment sums are index_add_, atomics in a varying order on
    CUDA."""
    dtype = tgt.dtype
    key = pc._voxel_keys(tgt, tgt_valid, resolution)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    pts_s = tgt[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=tgt.device),
                       ks[1:] != ks[:-1]])
    seg = torch.cumsum(first.long(), dim=0) - 1
    w = (ks != pc.INVALID_KEY).to(dtype)
    seg_c = torch.clamp(seg, 0, max_voxels - 1)

    def seg_sum(x):
        out = torch.zeros((max_voxels,) + tuple(x.shape[1:]), dtype=dtype,
                          device=tgt.device)
        return out.index_add_(0, seg_c, x)

    cnt = seg_sum(w)
    mean = seg_sum(pts_s * w[:, None]) / torch.clamp_min(cnt[:, None], 1.0)
    d = pts_s - mean[seg_c]
    cov = seg_sum(torch.einsum("p,pi,pj->pij", w, d, d))
    cov = cov / torch.clamp_min(cnt[:, None, None], 1.0)
    vvalid = cnt >= 5.0
    vals, vecs = torch.linalg.eigh(cov)
    floor = torch.clamp_min(vals[:, 2:3] * 1e-2, 1e-6)
    vals_r = torch.maximum(vals, floor)
    cov_r = torch.einsum("vij,vj,vkj->vik", vecs, vals_r, vecs)
    eye3 = torch.eye(3, dtype=dtype, device=tgt.device)
    cov_inv = torch.linalg.inv_ex(cov_r + 1e-9 * eye3)[0]
    return mean, cov_inv * vvalid[:, None, None], vvalid


def ndt_register(src: torch.Tensor, src_valid: torch.Tensor,
                 tgt: torch.Tensor, tgt_valid: torch.Tensor,
                 init_rot=None, init_t=None, resolution: float = 0.5,
                 iters: int = 35) -> RegistrationResult:
    """NDT registration: GN on the Mahalanobis distance of each source
    point to its nearest voxel distribution."""
    dtype, dev = src.dtype, src.device
    rot = torch.eye(3, dtype=dtype, device=dev) if init_rot is None \
        else init_rot
    t = torch.zeros(3, dtype=dtype, device=dev) if init_t is None else init_t
    centers, cov_inv, vvalid = build_ndt_grid(tgt, tgt_valid, resolution)
    stats = None
    for _ in range(iters):
        ps = src @ rot.T + t
        idx, d2, ok = pc.knn_indices(ps, src_valid, centers, vvalid, 1)
        nn = idx[:, 0]
        matched = ok[:, 0] & (d2[:, 0] < (1.5 * resolution) ** 2)
        r = ps - centers[nn]
        w = cov_inv[nn] * matched[:, None, None].to(dtype)
        rot, t, stats = _gn_step(rot, t, ps, r, w, matched, 1e-5)
    return _result(rot, t, stats)
