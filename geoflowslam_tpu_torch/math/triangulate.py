"""Two-view triangulation (port of geoflowslam_tpu/math/triangulate.py).

`triangulate_points` is the 3x3 normal-equation form that the stereo-fisheye
matcher, the monocular initializer and the monocular KF triangulation use;
`triangulate_dlt` is the homogeneous DLT through an SVD.
"""
from __future__ import annotations

import torch

from geoflowslam_tpu_torch.math.lie import hat


def triangulate_dlt(rays1: torch.Tensor, rays2: torch.Tensor,
                    p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Triangulate N points from two views: rays1, rays2 [N, 3] normalized
    image coordinates (x, y, 1), p1, p2 [3, 4] world -> camera projections
    [R | t]. Returns [N, 4] homogeneous world points, the right singular
    vector of the 4x4 DLT system with the smallest singular value (its sign
    and scale are the SVD's; the caller divides by w)."""
    a = torch.stack([rays1[:, 0:1] * p1[2] - p1[0],
                     rays1[:, 1:2] * p1[2] - p1[1],
                     rays2[:, 0:1] * p2[2] - p2[0],
                     rays2[:, 1:2] * p2[2] - p2[1]], dim=1)   # [N, 4, 4]
    return torch.linalg.svd(a, full_matrices=True)[2][:, 3, :]


def triangulate_points_f64(rays1: torch.Tensor, rays2: torch.Tensor,
                           rot21: torch.Tensor, t21: torch.Tensor):
    """triangulate_points solved in float64, the points returned in the
    rays' dtype. The monocular paths triangulate over baselines down to 1%
    of the depth, where the float32 normal equations lose ~1e-3 of the
    position (both packages, each elsewhere); in float64 the CPU and the
    card agree with the exact solution."""
    pts, valid = triangulate_points(rays1.double(), rays2.double(),
                                    rot21.double(), t21.double())
    return pts.to(rays1.dtype), valid


def triangulate_points(rays1: torch.Tensor, rays2: torch.Tensor,
                       rot21: torch.Tensor, t21: torch.Tensor):
    """Triangulate N points with camera 1 as the world (P1 = [I | 0], P2 =
    [R21 | t21]) from the two cross-product ray constraints cross(r1, X) = 0
    and cross(r2, R21 X + t21) = 0, solved as 3x3 normal equations with
    1e-9 I added. Returns (points in camera 1 [N, 3], valid [N]): positive
    depth in both cameras and finite."""
    r1 = rays1 / torch.linalg.norm(rays1, dim=-1, keepdim=True)
    r2 = rays2 / torch.linalg.norm(rays2, dim=-1, keepdim=True)
    a1 = hat(r1)                                        # [N, 3, 3]
    a2 = torch.einsum("nij,jk->nik", hat(r2), rot21)
    b2 = -torch.einsum("nij,j->ni", hat(r2), t21)
    h = (torch.einsum("nji,njk->nik", a1, a1)
         + torch.einsum("nji,njk->nik", a2, a2))
    g = torch.einsum("nji,nj->ni", a2, b2)
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    pts = torch.linalg.solve_ex(h + 1e-9 * eye, g[..., None])[0][..., 0]
    z1 = pts[:, 2]
    z2 = (pts @ rot21.T + t21)[:, 2]
    finite = torch.isfinite(pts).all(dim=1)
    return pts, (z1 > 0) & (z2 > 0) & finite
