"""SO(3)/SE(3)/Sim(3) functions (port of geoflowslam_tpu/math/lie.py),
batched over leading dims.

Conventions as in the reference: rotations are [..., 3, 3]; quaternions
are (w, x, y, z); SE(3) is a pair (R [..., 3, 3], t [..., 3]) acting as
x' = R x + t; Sim(3) a triple (s [...], R, t) acting as x' = s R x + t;
twists are [rho (trans), phi (rot)] and Sim(3) tangents [rho, phi, sigma]
like Sophus. Every map is Taylor-guarded near theta = 0 (and sigma = 0).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v: [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _coef_b_c(phi: torch.Tensor):
    """theta^2, small mask, (1-cos t)/t^2 and (t-sin t)/t^3 with Taylor
    fallbacks."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return theta2, theta, small, b, c


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues), Taylor-guarded near 0."""
    theta2, theta, small, b, _ = _coef_b_c(phi)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    k = hat(phi)
    return _eye_like(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr of SO(3)."""
    _, _, _, b, c = _coef_b_c(phi)
    k = hat(phi)
    return _eye_like(k) - b[..., None, None] * k + c[..., None, None] * (k @ k)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta2 - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.sin(theta)))
    k = hat(phi)
    return _eye_like(k) + 0.5 * k + cot_term[..., None, None] * (k @ k)


def quat_from_mat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branchless: the
    numerically best of the four constructions per element, w >= 0."""
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp_min(1.0 + tr, _EPS)) * 0.5
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)             # [..., 4, 4]
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2,
                     idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (axis * angle)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < _EPS
    scale = torch.where(small, 2.0 / torch.clamp_min(w, _EPS),
                        angle / torch.clamp_min(vnorm, _EPS))
    return v * scale[..., None]


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3) through the quaternion."""
    return quat_log(quat_from_mat(rot))


def normalize_rotation(rot: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) by a quaternion round trip."""
    q = quat_from_mat(rot)
    return mat_from_quat(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def se3_exp(xi: torch.Tensor):
    """Twist [rho, phi] ([..., 6]) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = so3_exp(phi)
    _, _, _, b, c = _coef_b_c(phi)
    k = hat(phi)
    v_mat = _eye_like(k) + b[..., None, None] * k + c[..., None, None] * (k @ k)
    return rot, torch.einsum("...ij,...j->...i", v_mat, rho)


def se3_log(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist [rho, phi]."""
    phi = so3_log(rot)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp_min(torch.sin(half), _EPS)) / theta2)
    k = hat(phi)
    v_inv = _eye_like(k) - 0.5 * k + cot_term[..., None, None] * (k @ k)
    rho = torch.einsum("...ij,...j->...i", v_inv, t)
    return torch.cat([rho, phi], dim=-1)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SE(3) at the twist xi = [rho, phi]
    ([..., 6] -> [..., 6, 6]): log(exp(xi) exp(d)) = xi + Jr^-1(xi) d to
    first order. Jr^-1(xi) = Jl^-1(-xi) = [[J^-1, -J^-1 Q J^-1], [0, J^-1]]
    with J the SO(3) left Jacobian and Q Barfoot's coupling block, both at
    -xi. Below theta = 0.5 the coefficients are their Taylor series (their
    closed forms cancel badly in float32)."""
    rho, phi = -xi[..., :3], -xi[..., 3:]
    th2 = torch.sum(phi * phi, dim=-1)
    th = torch.sqrt(torch.clamp_min(th2, _EPS * _EPS))
    small = th2 < 0.25
    th_c = torch.where(small, torch.ones_like(th), th)   # closed forms only
    s, c = torch.sin(th_c), torch.cos(th_c)
    t2, t4, t6 = th2, th2 * th2, th2 * th2 * th2
    # J^-1 = I - phi^ / 2 + cot_term phi^ phi^
    cot_term = torch.where(small,
                          1 / 12 + t2 / 720 + t4 / 30240 + t6 / 1209600,
                          1 / th_c ** 2 - (1 + c) / (2 * th_c * s))
    c1 = torch.where(small, 1 / 6 - t2 / 120 + t4 / 5040 - t6 / 362880,
                    (th_c - s) / th_c ** 3)
    c2 = torch.where(small, 1 / 24 - t2 / 720 + t4 / 40320 - t6 / 3628800,
                    (th_c ** 2 + 2 * c - 2) / (2 * th_c ** 4))
    c3 = torch.where(small, 1 / 120 - t2 / 2520 + t4 / 120960
                    - t6 / 9979200,
                    (2 * th_c - 3 * s + th_c * c) / (2 * th_c ** 5))
    p, r = hat(phi), hat(rho)
    pr, rp = p @ r, r @ p
    prp = pr @ p
    q = (0.5 * r + c1[..., None, None] * (pr + rp + prp)
         + c2[..., None, None] * (p @ pr + rp @ p - 3.0 * prp)
         + c3[..., None, None] * (prp @ p + p @ prp))
    jinv = _eye_like(p) - 0.5 * p + cot_term[..., None, None] * (p @ p)
    top = torch.cat([jinv, -jinv @ q @ jinv], dim=-1)
    bottom = torch.cat([torch.zeros_like(jinv), jinv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_adjoint(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Adjoint of (R, t) on twists [rho, phi]: [[R, t^ R], [0, R]]."""
    top = torch.cat([rot, hat(t) @ rot], dim=-1)
    bottom = torch.cat([torch.zeros_like(rot), rot], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_compose(ra, ta, rb, tb):
    """(Ra, ta) * (Rb, tb): apply b first, then a."""
    return ra @ rb, torch.einsum("...ij,...j->...i", ra, tb) + ta


def se3_inverse(rot, t):
    rinv = rot.transpose(-1, -2)
    return rinv, -torch.einsum("...ij,...j->...i", rinv, t)


def sim3_compose(sa, ra, ta, sb, rb, tb):
    """(sa, Ra, ta) * (sb, Rb, tb): x -> sa Ra (sb Rb x + tb) + ta."""
    return (sa * sb, ra @ rb,
            sa[..., None] * torch.einsum("...ij,...j->...i", ra, tb) + ta)


def sim3_inverse(s, rot, t):
    rinv = rot.transpose(-1, -2)
    sinv = 1.0 / s
    return sinv, rinv, -sinv[..., None] * torch.einsum("...ij,...j->...i",
                                                       rinv, t)


def sim3_apply(s, rot, t, pts):
    """[...], [..., 3, 3], [..., 3], [..., N, 3] -> [..., N, 3]."""
    return (s[..., None, None] * torch.einsum("...ij,...nj->...ni", rot, pts)
            + t[..., None, :])


def sim3_exp(xi: torch.Tensor):
    """7-vector [rho, phi, sigma] -> (s, R, t), Sophus's Sim3 exp (its W
    matrix couples the translation to rotation and scale)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    rot = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    k = hat(phi)
    eye = _eye_like(k)
    small_sig = torch.abs(sigma) < _EPS
    small_th = theta2 < _EPS
    ones = torch.ones_like(sigma)
    sig_safe = torch.where(small_sig, ones, sigma)
    th_safe = torch.where(small_th, ones, theta)
    a_coef = torch.where(small_sig, torch.zeros_like(sigma),
                         (s - 1.0) / sig_safe)
    c_coef = torch.where(small_sig, ones, a_coef)
    denom = sig_safe * sig_safe + theta2
    sin_t, cos_t = torch.sin(th_safe), torch.cos(th_safe)
    a_big = torch.where(
        small_sig, (1.0 - cos_t) / torch.clamp_min(theta2, _EPS),
        (s * sin_t * sig_safe + (1.0 - s * cos_t) * th_safe)
        / torch.clamp_min(th_safe * denom, _EPS))
    b_big = torch.where(
        small_sig, (th_safe - sin_t) / torch.clamp_min(theta2 * th_safe, _EPS),
        (c_coef - ((s * cos_t - 1.0) * sig_safe + s * sin_t * th_safe)
         / torch.clamp_min(denom, _EPS)) / torch.clamp_min(theta2, _EPS))
    a_small = torch.where(small_sig, 0.5 * ones,
                          ((sig_safe - 1.0) * s + 1.0)
                          / torch.clamp_min(sig_safe * sig_safe, _EPS))
    a_final = torch.where(small_th, a_small, a_big)
    b_final = torch.where(small_th, torch.zeros_like(sigma), b_big)
    w_mat = (c_coef[..., None, None] * eye + a_final[..., None, None] * k
             + b_final[..., None, None] * (k @ k))
    return s, rot, torch.einsum("...ij,...j->...i", w_mat, rho)
