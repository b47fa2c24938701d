"""Point-cloud primitives (port of the RGB-D part of
geoflowslam_tpu/ops/pointcloud.py): depth back-projection, voxel
downsampling, brute-force kNN and the GICP covariances. Clouds are
fixed-capacity [P, 3] tensors with validity masks.

The kNN distance matrix is |q|^2 - 2 q.t + |t|^2 through one matmul, as the
reference leaves it to XLA; the package turns TF32 off, which this
expansion needs (it cancels badly at three decimal digits). Ties go to the
lowest target index, as jnp.argmin and jax.lax.top_k break them.
"""
from __future__ import annotations

from typing import Tuple

import math

import torch

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


def _voxel_keys(pts: torch.Tensor, valid: torch.Tensor, voxel: float):
    """int32-range voxel key per point, 10 bits per axis (+-25 m at 5 cm);
    invalid points get INVALID_KEY and sort last."""
    ijk = torch.clamp(torch.floor(pts / voxel).long() + 512, 0, 1023)
    key = (ijk[:, 0] << 20) | (ijk[:, 1] << 10) | ijk[:, 2]
    return torch.where(valid, key, INVALID_KEY)


def voxel_downsample(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                     max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first point per voxel after a stable key sort, compacted to
    [max_out] (deterministic small_gicp::voxelgrid_sampling analogue)."""
    key = _voxel_keys(pts, valid, voxel)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=pts.device),
                       ks[1:] != ks[:-1]])
    first = first & (ks != INVALID_KEY)
    rank = torch.argsort((~first).to(torch.int8), stable=True)
    sel = order[rank[:max_out]]
    return pts[sel], first[rank[:max_out]]


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


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors along the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def _trig_eig(a: torch.Tensor):
    """(q, p, phi) of the trigonometric eigenvalue method for symmetric
    3x3 batches: eigenvalues q + 2 p cos(phi + 2 pi j / 3)."""
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    p1 = a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2 + a[..., 1, 2] ** 2
    d = torch.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], dim=-1)
    p2 = torch.sum((d - q[..., None]) ** 2, dim=-1) + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(0.5 * _det3(b), -1.0, 1.0)
    return q, p, torch.arccos(r) / 3.0


def sym3_eigvals(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues [..., 3] of symmetric 3x3 batches, closed
    form (no iterative eigh)."""
    q, p, phi = _trig_eig(a)
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def smallest_eigvec_sym3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of [N, 3, 3] symmetric
    matrices: the largest cross product of two columns of A - lambda_min I;
    isotropic or degenerate inputs give +z."""
    q, p, phi = _trig_eig(a)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    m = a - lam_min[:, None, None] * torch.eye(3, dtype=a.dtype,
                                               device=a.device)
    c0, c1, c2 = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    cands = torch.stack([torch.linalg.cross(c0, c1),
                         torch.linalg.cross(c0, c2),
                         torch.linalg.cross(c1, c2)], dim=1)   # [N, 3, 3]
    norms = torch.linalg.norm(cands, dim=2)
    best = torch.argmax(norms, dim=1)
    v = torch.gather(cands, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    nrm = torch.linalg.norm(v, dim=1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype,
                            device=a.device).expand_as(v)
    return torch.where(nrm > 1e-12, v / torch.clamp_min(nrm, 1e-30), fallback)


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
