"""On-manifold IMU preintegration (port of
geoflowslam_tpu/imu/preintegration.py).

IMU::Preintegrated's quantities between two frames or two keyframes:
  * the deltas dR, dV, dP;
  * the bias Jacobians JRg, JVg, JVa, JPg, JPa;
  * the 15x15 covariance of [dR, dV, dP, bg, ba] (measurement noise plus
    the bias random walk).
The reference order of one step: the position with the old rotation
(dP += dV dt + 0.5 a dt^2), then the velocity, then the rotation composed
on the right; the covariance goes through the same A/B matrices.

The samples live on the host, and every consumer of a KF segment (the
segment stack of VI-BA, the IMU initializer) is host code, so `preintegrate`
runs on the host in numpy float32, one step per valid sample (rows with
dt = 0 are padding, an identity step). A frame's preintegration is uploaded
to the device in one copy (`to_device`), where `predict_state` and the VI
solvers read it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.utils.device_const import upload

GRAVITY = np.array([0.0, 0.0, -9.81], np.float32)   # IMU::GRAVITY_VALUE
_EPS = np.float32(1e-8)
_F = np.float32


class ImuCalib(NamedTuple):
    """IMU::Calib: body <- cam extrinsics and the noise covariances (host
    float32)."""
    r_bc: np.ndarray       # [3, 3] rotation cam -> body
    t_bc: np.ndarray       # [3]
    cov: np.ndarray        # [6, 6] gyro/acc white noise (Nga)
    cov_walk: np.ndarray   # [6, 6] bias random walk (NgaWalk)

    @staticmethod
    def create(t_bc_mat, noise_gyro, noise_acc, walk_gyro, walk_acc, freq):
        sf = np.sqrt(_F(freq))
        ng, na = _F(noise_gyro) * sf, _F(noise_acc) * sf
        wg, wa = _F(walk_gyro) / sf, _F(walk_acc) / sf
        cov = np.diag(np.array([ng * ng] * 3 + [na * na] * 3, _F))
        cov_walk = np.diag(np.array([wg * wg] * 3 + [wa * wa] * 3, _F))
        t_bc_mat = np.asarray(t_bc_mat, _F)
        return ImuCalib(t_bc_mat[:3, :3], t_bc_mat[:3, 3], cov, cov_walk)


class Preintegrated(NamedTuple):
    """IMU::Preintegrated as arrays: numpy on the host; `to_device` makes a
    torch copy of the fields the device reads (meas_* stay None there)."""
    dt: object          # [] total time
    dR: object          # [3, 3]
    dV: object          # [3]
    dP: object          # [3]
    JRg: object         # [3, 3] d(dR)/d(bias_gyro)
    JVg: object
    JVa: object
    JPg: object
    JPa: object
    cov: object         # [15, 15]
    bias: object        # [6] (bg, ba) used during integration
    meas_acc: object    # [MAX, 3] raw samples kept for reintegration
    meas_gyro: object   # [MAX, 3]
    meas_dt: object     # [MAX]

    @staticmethod
    def identity(max_meas: int, bias=None):
        z3 = np.zeros((3, 3), _F)
        return Preintegrated(
            dt=_F(0.0), dR=np.eye(3, dtype=_F), dV=np.zeros(3, _F),
            dP=np.zeros(3, _F), JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
            cov=np.zeros((15, 15), _F),
            bias=np.zeros(6, _F) if bias is None else np.asarray(bias, _F),
            meas_acc=np.zeros((max_meas, 3), _F),
            meas_gyro=np.zeros((max_meas, 3), _F),
            meas_dt=np.zeros((max_meas,), _F))


# -- float32 SO(3) on the host (the formulas of math/lie.py) -----------------

def _hat(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]], _F)


def _hat_batch(v):
    z = np.zeros(v.shape[:-1], _F)
    return np.stack([np.stack([z, -v[..., 2], v[..., 1]], -1),
                     np.stack([v[..., 2], z, -v[..., 0]], -1),
                     np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_and_right_jacobian(phi):
    """so3_exp and so3_right_jacobian of [S, 3] rotation vectors."""
    theta2 = np.sum(phi * phi, axis=-1)
    theta = np.sqrt(np.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
        b = np.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - np.cos(theta)) / theta2)
        c = np.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - np.sin(theta)) / (theta2 * theta))
    a, b, c = (x.astype(_F)[:, None, None] for x in (a, b, c))
    k = _hat_batch(phi)
    kk = k @ k
    eye = np.eye(3, dtype=_F)
    return eye + a * k + b * kk, eye - b * k + c * kk


def normalize_rotation(m):
    """Quaternion round trip of a near-rotation (lie.normalize_rotation)."""
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    tr = m00 + m11 + m22
    scores = (tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11)
    i = int(np.argmax(scores))
    if i == 0:
        w = np.sqrt(max(1.0 + tr, _EPS)) * 0.5
        q = (w, (m21 - m12) / (4 * w), (m02 - m20) / (4 * w),
             (m10 - m01) / (4 * w))
    elif i == 1:
        x = np.sqrt(max(1.0 + m00 - m11 - m22, _EPS)) * 0.5
        q = ((m21 - m12) / (4 * x), x, (m01 + m10) / (4 * x),
             (m02 + m20) / (4 * x))
    elif i == 2:
        y = np.sqrt(max(1.0 - m00 + m11 - m22, _EPS)) * 0.5
        q = ((m02 - m20) / (4 * y), (m01 + m10) / (4 * y), y,
             (m12 + m21) / (4 * y))
    else:
        z = np.sqrt(max(1.0 - m00 - m11 + m22, _EPS)) * 0.5
        q = ((m10 - m01) / (4 * z), (m02 + m20) / (4 * z),
             (m12 + m21) / (4 * z), z)
    q = np.asarray(q, _F)
    q = q / np.linalg.norm(q)                  # quat_from_mat's normalize
    w, x, y, z = q / np.linalg.norm(q)         # and normalize_rotation's
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], _F)


def host_f32(x) -> np.ndarray:
    """A numpy array or tensor as host numpy float32."""
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, _F)


# -- preintegration on the host ----------------------------------------------

def preintegrate(acc, gyro, dts, bias, calib: ImuCalib) -> Preintegrated:
    """Integrate a padded batch of IMU samples (IntegrateNewMeasurement per
    sample). acc, gyro [MAX, 3]; dts [MAX] (0 = padding); bias [6]
    (bg, ba). Inputs may be numpy arrays or tensors; the result is host
    numpy float32."""
    acc, gyro, dts, bias = (host_f32(x) for x in (acc, gyro, dts, bias))
    cov_n, cov_w = host_f32(calib.cov), host_f32(calib.cov_walk)
    eye3 = np.eye(3, dtype=_F)
    dt_tot = _F(0.0)
    d_r, d_v, d_p = eye3.copy(), np.zeros(3, _F), np.zeros(3, _F)
    j_rg = np.zeros((3, 3), _F)
    j_vg, j_va, j_pg, j_pa = j_rg.copy(), j_rg.copy(), j_rg.copy(), j_rg.copy()
    cov = np.zeros((15, 15), _F)
    sel = np.nonzero(dts > 0)[0]
    if len(sel):
        a_all = acc[sel] - bias[3:]
        w_all = gyro[sel] - bias[:3]
        dt_all = dts[sel]
        d_ri_all, rj_all = _exp_and_right_jacobian(w_all * dt_all[:, None])
    for k in range(len(sel)):
        a, dt = a_all[k], dt_all[k]
        dt2 = _F(0.5) * dt * dt
        acc_w = d_r @ a
        d_p = d_p + d_v * dt + acc_w * dt2
        d_v = d_v + acc_w * dt
        r_ah = d_r @ _hat(a)
        a_mat = np.eye(9, dtype=_F)
        a_mat[3:6, 0:3] = -r_ah * dt
        a_mat[6:9, 0:3] = -r_ah * dt2
        a_mat[6:9, 3:6] = eye3 * dt
        b_mat = np.zeros((9, 6), _F)
        b_mat[3:6, 3:6] = d_r * dt
        b_mat[6:9, 3:6] = d_r * dt2
        j_pa = j_pa + j_va * dt - d_r * dt2
        j_pg = j_pg + j_vg * dt - (r_ah @ j_rg) * dt2
        j_va = j_va - d_r * dt
        j_vg = j_vg - (r_ah @ j_rg) * dt
        d_ri, r_j = d_ri_all[k], rj_all[k]
        d_r = normalize_rotation(d_r @ d_ri)
        a_mat[0:3, 0:3] = d_ri.T
        b_mat[0:3, 0:3] = r_j * dt
        c99 = a_mat @ cov[:9, :9] @ a_mat.T + b_mat @ cov_n @ b_mat.T
        c_bias = cov[9:15, 9:15] + cov_w
        cov = np.zeros((15, 15), _F)
        cov[:9, :9] = c99
        cov[9:15, 9:15] = c_bias
        j_rg = d_ri.T @ j_rg - r_j * dt
        dt_tot = _F(dt_tot + dt)
    return Preintegrated(dt=_F(dt_tot), dR=d_r, dV=d_v, dP=d_p, JRg=j_rg,
                         JVg=j_vg, JVa=j_va, JPg=j_pg, JPa=j_pa, cov=cov,
                         bias=bias, meas_acc=acc, meas_gyro=gyro, meas_dt=dts)


def reintegrate(p: Preintegrated, new_bias, calib: ImuCalib) -> Preintegrated:
    """IMU::Preintegrated::Reintegrate with an updated bias."""
    return preintegrate(p.meas_acc, p.meas_gyro, p.meas_dt, new_bias, calib)


def merge_previous(prev: Preintegrated, cur: Preintegrated,
                   calib: ImuCalib) -> Preintegrated:
    """IMU::Preintegrated::MergePrevious: prev's samples in front of cur's
    (valid rows first, order kept, 2 x MAX capacity), reintegrated with
    cur's bias."""
    acc = np.concatenate([prev.meas_acc, cur.meas_acc])
    gyro = np.concatenate([prev.meas_gyro, cur.meas_gyro])
    dts = np.concatenate([prev.meas_dt, cur.meas_dt])
    order = np.argsort(np.where(dts > 0, 0, 1), kind="stable")
    return preintegrate(acc[order], gyro[order], dts[order], cur.bias, calib)


_DEVICE_FIELDS = (("dt", ()), ("dR", (3, 3)), ("dV", (3,)), ("dP", (3,)),
                  ("JRg", (3, 3)), ("JVg", (3, 3)), ("JVa", (3, 3)),
                  ("JPg", (3, 3)), ("JPa", (3, 3)), ("cov", (15, 15)),
                  ("bias", (6,)))


def to_device(p: Preintegrated, device) -> Preintegrated:
    """The deltas, Jacobians, covariance and bias of `p` on `device`, in one
    host-to-device copy that the host does not wait for (views of one packed
    tensor)."""
    flat = np.concatenate([np.asarray(getattr(p, f), _F).reshape(-1)
                           for f, _ in _DEVICE_FIELDS])
    buf = upload(flat, device)
    out, i = {}, 0
    for f, shape in _DEVICE_FIELDS:
        n = int(np.prod(shape)) if shape else 1
        out[f] = buf[i:i + n].reshape(shape)
        i += n
    return Preintegrated(meas_acc=None, meas_gyro=None, meas_dt=None, **out)


# -- bias-corrected deltas and the state prediction (torch, any device;
# -- batched over leading dims of p and bias) -----------------------------

def mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., n, m] x [..., m]."""
    return (a @ x[..., None])[..., 0]


def delta_rotation(p: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg = bias[..., :3] - p.bias[..., :3]
    return lie.normalize_rotation(p.dR @ lie.so3_exp(mv(p.JRg, dbg)))


def delta_velocity(p: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg = bias[..., :3] - p.bias[..., :3]
    dba = bias[..., 3:] - p.bias[..., 3:]
    return p.dV + mv(p.JVg, dbg) + mv(p.JVa, dba)


def delta_position(p: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg = bias[..., :3] - p.bias[..., :3]
    dba = bias[..., 3:] - p.bias[..., 3:]
    return p.dP + mv(p.JPg, dbg) + mv(p.JPa, dba)


_GRAVITY_ON: dict = {}


def gravity(like: torch.Tensor) -> torch.Tensor:
    """GRAVITY on `like`'s device (copied there once)."""
    g = _GRAVITY_ON.get(like.device)
    if g is None:
        g = _GRAVITY_ON[like.device] = torch.from_numpy(GRAVITY).to(
            like.device)
    return g


def predict_state(rot_wb1, t_wb1, v1, p: Preintegrated, bias):
    """PredictStateIMU: world-from-body (R, p) and velocity at frame 2."""
    g = gravity(rot_wb1)
    dt = p.dt
    rot_wb2 = lie.normalize_rotation(rot_wb1 @ delta_rotation(p, bias))
    t_wb2 = (t_wb1 + v1 * dt + 0.5 * g * dt * dt
             + rot_wb1 @ delta_position(p, bias))
    v2 = v1 + g * dt + rot_wb1 @ delta_velocity(p, bias)
    return rot_wb2, t_wb2, v2
