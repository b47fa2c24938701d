"""Camera models: pinhole (with radial-tangential undistortion) and
Kannala-Brandt-8 fisheye (port of geoflowslam_tpu/math/cameras.py).

Every model is a set of batched float32 functions of a flat parameter
tensor: pinhole [fx, fy, cx, cy], KB8 [fx, fy, cx, cy, k0, k1, k2, k3].
Projection takes camera-frame points [..., 3] to pixels [..., 2];
unprojection takes pixels to unit-depth rays (z = 1). The KB8 Jacobian is
in closed form (the reference differentiates the projection with jacfwd).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-9

PINHOLE = 0
KB8 = 1


def _params(params, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(params, dtype=torch.float32, device=like.device)


def _safe_inv(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < _EPS, _EPS, z)


# -- pinhole -----------------------------------------------------------------

def pinhole_project(params, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2]."""
    p = _params(params, pts_cam)
    inv_z = _safe_inv(pts_cam[..., 2])
    return torch.stack([p[0] * pts_cam[..., 0] * inv_z + p[2],
                        p[1] * pts_cam[..., 1] * inv_z + p[3]], dim=-1)


def pinhole_unproject(params, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> unit-depth rays [..., 3]."""
    p = _params(params, uv)
    x = (uv[..., 0] - p[2]) / p[0]
    y = (uv[..., 1] - p[3]) / p[1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params, pts_cam: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(pt_cam): [..., 2, 3]."""
    p = _params(params, pts_cam)
    x, y = pts_cam[..., 0], pts_cam[..., 1]
    inv_z = _safe_inv(pts_cam[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([p[0] * inv_z, zero, -p[0] * x * inv_z2], dim=-1)
    row1 = torch.stack([zero, p[1] * inv_z, -p[1] * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def radtan_distort(dist, xy: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion [k1, k2, p1, p2, (k3)] of normalized xy."""
    d = _params(dist, xy)
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    k3 = d[4] if d.shape[0] > 4 else torch.zeros_like(k1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(dist, xy_d: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the radtan distortion by `iters` fixed-point steps from the
    distorted point."""
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (radtan_distort(dist, xy) - xy)
    return xy


# -- Kannala-Brandt 8 ----------------------------------------------------------

def _theta_poly(theta, k0, k1, k2, k3):
    """(theta_d, d theta_d / d theta) of the KB8 polynomial."""
    t2 = theta * theta
    td = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    dtd = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
    return td, dtd


def kb8_project(params, pts_cam: torch.Tensor) -> torch.Tensor:
    """KB8 theta-polynomial projection."""
    p = _params(params, pts_cam)
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    r = torch.sqrt(x * x + y * y)
    td, _ = _theta_poly(torch.atan2(r, z), p[4], p[5], p[6], p[7])
    scale = torch.where(r < _EPS, 1.0 / torch.clamp_min(z, _EPS),
                        td / torch.clamp_min(r, _EPS))
    return torch.stack([p[0] * x * scale + p[2], p[1] * y * scale + p[3]],
                       dim=-1)


def kb8_unproject(params, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert the theta polynomial by `iters` Newton steps; theta_d is
    clipped to pi/2 before them. Returns unit-depth rays."""
    p = _params(params, uv)
    mx = (uv[..., 0] - p[2]) / p[0]
    my = (uv[..., 1] - p[3]) / p[1]
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, 0.0, math.pi / 2)
    theta = theta_d_c
    for _ in range(iters):
        td, dtd = _theta_poly(theta, p[4], p[5], p[6], p[7])
        theta = theta - (td - theta_d_c) / torch.clamp_min(dtd, _EPS)
    scale = torch.where(theta_d < _EPS, torch.ones_like(theta),
                        torch.tan(theta) / torch.clamp_min(theta_d, _EPS))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params, pts_cam: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(pt_cam) of kb8_project: [..., 2, 3]. With q = theta_d / r,
    u = fx x q + cx: du/dx = fx (q + x dq/dx), du/dy = fx x dq/dy, du/dz =
    fx x dq/dz, where dq/dx = theta_d' dtheta/dx / r - theta_d x / r^3,
    dtheta/dx = x z / (r (r^2 + z^2)) and dq/dz = -theta_d' / (r^2 + z^2).
    On the optical axis (r < 1e-9) the projection is the pinhole one."""
    p = _params(params, pts_cam)
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    r = torch.sqrt(x * x + y * y)
    rs = torch.clamp_min(r, _EPS)
    theta = torch.atan2(r, z)
    td, dtd = _theta_poly(theta, p[4], p[5], p[6], p[7])
    rho2 = r * r + z * z
    q = td / rs
    # d theta / dx = x z / (r rho2); dq/dx = (dtd dtheta/dx) / r - td x / r^3
    dq_dx = dtd * x * z / (rs * rs * rho2) - td * x / (rs ** 3)
    dq_dy = dtd * y * z / (rs * rs * rho2) - td * y / (rs ** 3)
    dq_dz = -dtd / rho2
    fx, fy = p[0], p[1]
    row0 = torch.stack([fx * (q + x * dq_dx), fx * x * dq_dy, fx * x * dq_dz],
                       dim=-1)
    row1 = torch.stack([fy * y * dq_dx, fy * (q + y * dq_dy), fy * y * dq_dz],
                       dim=-1)
    jac = torch.stack([row0, row1], dim=-2)
    on_axis = (r < _EPS)[..., None, None]
    inv_z = 1.0 / torch.clamp_min(z, _EPS)
    zero = torch.zeros_like(x)
    axis = torch.stack([
        torch.stack([fx * inv_z, zero, zero], dim=-1),
        torch.stack([zero, fy * inv_z, zero], dim=-1)], dim=-2)
    return torch.where(on_axis, axis, jac)


# -- model dispatch (model id 0 = pinhole, 1 = KB8) ------------------------------

def project(model_id: int, params, pts_cam: torch.Tensor) -> torch.Tensor:
    if model_id == PINHOLE:
        return pinhole_project(params, pts_cam)
    return kb8_project(params, pts_cam)


def unproject(model_id: int, params, uv: torch.Tensor) -> torch.Tensor:
    if model_id == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model_id: int, params, pts_cam: torch.Tensor) -> torch.Tensor:
    if model_id == PINHOLE:
        return pinhole_project_jac(params, pts_cam)
    return kb8_project_jac(params, pts_cam)
