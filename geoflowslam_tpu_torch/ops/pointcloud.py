"""Point-cloud primitives (port of the RGB-D part of
geoflowslam_tpu/ops/pointcloud.py): depth back-projection, the edge/surf
feature cloud of the lidar factors, voxel downsampling, brute-force kNN and
the GICP covariances. Clouds are
fixed-capacity [P, 3] tensors with validity masks.

The kNN distance matrix is |q|^2 - 2 q.t + |t|^2 through one matmul, as the
reference leaves it to XLA; the package turns TF32 off, which this
expansion needs (it cancels badly at three decimal digits). Ties go to the
lowest target index, as jnp.argmin and jax.lax.top_k break them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from geoflowslam_tpu_torch.math import sym_eig as SE
from geoflowslam_tpu_torch.ops.indexing import topk_stable

INVALID_KEY = 0x7FFFFFFF


def depth_to_cloud(depth: torch.Tensor, fx, fy, cx, cy, stride: int = 3,
                   max_depth: float = 10.0, min_depth: float = 0.05):
    """Back-project a depth image [H, W] -> ([P, 3] points, [P] mask) with
    P = ceil(H / stride) * ceil(W / stride)."""
    d = depth[::stride, ::stride]
    hs, ws = d.shape
    ys = (torch.arange(hs, dtype=depth.dtype, device=depth.device)
          * stride)[:, None]
    xs = (torch.arange(ws, dtype=depth.dtype, device=depth.device)
          * stride)[None, :]
    z = d
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    mask = ((z > min_depth) & (z < max_depth) & torch.isfinite(z)).reshape(-1)
    return pts, mask


def lidar_feature_cloud(depth: torch.Tensor, fx, fy, cx, cy, stride: int = 3,
                        max_depth: float = 10.0, min_depth: float = 0.05,
                        edge_curv: float = 0.1, edges_per_row: int = 10):
    """SSL_SLAM2-style edge/surf features of the organized depth cloud: the
    rows of the strided depth image are the scan lines; the curvature
    c_j = |sum_{k=-5..5} p_{j+k} - 10 p_j|^2 / |p_j|^2 along each row (the
    ends of a row, where the window wraps, are masked); per row the
    `edges_per_row` highest local maxima (+-5 columns) above `edge_curv`
    are edges, the other points with a full window are surf. Returns
    ([P, 3] points, [P] valid, [P] is_edge) in depth_to_cloud's layout."""
    hs, ws = depth[::stride, ::stride].shape
    pts, mask = depth_to_cloud(depth, fx, fy, cx, cy, stride, max_depth,
                               min_depth)
    p, ok = pts.reshape(hs, ws, 3), mask.reshape(hs, ws)
    pz = torch.where(ok[..., None], p, 0.0)
    acc = -11.0 * pz
    win_ok = ok
    for k in range(-5, 6):
        acc = acc + torch.roll(pz, -k, dims=1)
        win_ok = win_ok & torch.roll(ok, -k, dims=1)
    col = torch.arange(ws, device=depth.device)[None, :]
    win_ok = win_ok & (col >= 5) & (col < ws - 5)
    dist2 = torch.clamp_min(torch.sum(p * p, dim=-1), 1e-6)
    curv = torch.where(win_ok, torch.sum(acc * acc, dim=-1) / dist2, -1.0)
    local_max = curv
    for k in range(1, 6):
        local_max = torch.maximum(local_max, torch.roll(curv, k, dims=1))
        local_max = torch.maximum(local_max, torch.roll(curv, -k, dims=1))
    is_peak = (curv >= local_max) & (curv > edge_curv)
    topv, topi = topk_stable(torch.where(is_peak, curv, -1.0),
                             min(edges_per_row, ws))
    # top-k indices are distinct within a row: one write each
    keep = torch.zeros((hs, ws), dtype=torch.bool, device=depth.device)
    keep = keep.scatter(1, topi, topv > 0)
    is_edge = keep & win_ok
    is_surf = win_ok & ~is_edge
    valid = (is_edge | is_surf) & ok
    return p.reshape(-1, 3), valid.reshape(-1), is_edge.reshape(-1)


def _voxel_keys(pts: torch.Tensor, valid: torch.Tensor, voxel: float):
    """int32-range voxel key per point, 10 bits per axis (+-25 m at 5 cm);
    invalid points get INVALID_KEY and sort last."""
    ijk = torch.clamp(torch.floor(pts / voxel).long() + 512, 0, 1023)
    key = (ijk[:, 0] << 20) | (ijk[:, 1] << 10) | ijk[:, 2]
    return torch.where(valid, key, INVALID_KEY)


def voxel_select(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                 max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices [max_out], validity [max_out]) of the first point per voxel
    after a stable key sort, compacted to the front."""
    key = _voxel_keys(pts, valid, voxel)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=pts.device),
                       ks[1:] != ks[:-1]])
    first = first & (ks != INVALID_KEY)
    rank = torch.argsort((~first).to(torch.int8), stable=True)
    return order[rank[:max_out]], first[rank[:max_out]]


def voxel_downsample(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                     max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first point per voxel after a stable key sort, compacted to
    [max_out] (deterministic small_gicp::voxelgrid_sampling analogue)."""
    sel, ok = voxel_select(pts, valid, voxel, max_out)
    return pts[sel], ok


def knn_indices(query: torch.Tensor, q_valid: torch.Tensor,
                target: torch.Tensor, t_valid: torch.Tensor, k: int):
    """Brute-force kNN: ([Q, k] indices, [Q, k] squared distances, [Q, k]
    validity)."""
    d2 = (torch.sum(query * query, dim=1)[:, None]
          - 2.0 * query @ target.T
          + torch.sum(target * target, dim=1)[None, :])
    d2 = torch.where(t_valid[None, :], d2, float("inf"))
    if k == 1:
        idx = torch.argmin(d2, dim=1, keepdim=True)
        best = torch.gather(d2, 1, idx)
    else:
        neg, idx = topk_stable(-d2, k)
        best = -neg
    ok = torch.isfinite(best) & q_valid[:, None]
    return idx, best, ok


def smallest_eigvec_sym3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of [N, 3, 3] symmetric
    matrices: the largest cross product of two columns of A - lambda_min I;
    isotropic or degenerate inputs give +z."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    lam_min = SE.eigvals3(a)[:, 0]
    v = SE.kernel_direction3(a - lam_min[:, None, None] * eye)
    nrm = torch.linalg.norm(v, dim=1, keepdim=True)
    return torch.where(nrm > 1e-12, v / torch.clamp_min(nrm, 1e-30),
                       eye[2].expand_as(v))


def estimate_covariances(pts: torch.Tensor, valid: torch.Tensor, k: int = 10,
                         eps: float = 1e-3):
    """Per-point kNN covariance regularized for plane-to-plane GICP: the
    eigenvalues become [eps, 1, 1], i.e. I - (1 - eps) n n^T with n the
    smallest-eigenvalue eigenvector. Returns (cov_reg [P, 3, 3], n [P, 3])."""
    idx, _, ok = knn_indices(pts, valid, pts, valid, k)
    nb = pts[idx]                                          # [P, k, 3]
    w = ok.to(pts.dtype)
    n = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1.0)
    mean = torch.sum(nb * w[..., None], dim=1) / n
    c = nb - mean[:, None, :]
    cov = torch.einsum("pk,pki,pkj->pij", w, c, c) / n[..., None]
    normal = smallest_eigvec_sym3(cov)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    cov_reg = eye - (1.0 - eps) * normal[:, :, None] * normal[:, None, :]
    return cov_reg, normal


def transform_cloud(rot, t, pts):
    return pts @ rot.T + t
