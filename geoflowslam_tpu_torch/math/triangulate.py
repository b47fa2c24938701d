"""Two-view triangulation (port of geoflowslam_tpu/math/triangulate.py).

`triangulate_points` is the 3x3 normal-equation form that the stereo-fisheye
matcher uses. The homogeneous DLT through an SVD (`triangulate_dlt`) is the
monocular initializer's and comes with the monocular slice.
"""
from __future__ import annotations

import torch

from geoflowslam_tpu_torch.math.lie import hat


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
