"""Trajectory export in TUM / KITTI / EuRoC formats.

Port of geoflowslam_tpu/io/trajectory.py, itself a port of the reference's
System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM / SaveTrajectoryKITTI
/ SaveTrajectoryEuRoC (src/System.cc:994-2100): the same file layouts, byte
for byte, so the reference's evaluators (script/evaluator/*) read them.
Host numpy; `keyframe_trajectory` reads a MapState on any device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), TUM ordering."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        qw = (m[2, 1] - m[1, 2]) / s
        qx = 0.25 * s
        qy = (m[0, 1] + m[1, 0]) / s
        qz = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        qw = (m[0, 2] - m[2, 0]) / s
        qx = (m[0, 1] + m[1, 0]) / s
        qy = 0.25 * s
        qz = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        qw = (m[1, 0] - m[0, 1]) / s
        qx = (m[0, 2] + m[2, 0]) / s
        qy = (m[1, 2] + m[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw])


def save_trajectory_tum(path: str, traj: Sequence[Tuple[float, np.ndarray]]):
    """`t tx ty tz qx qy qz qw` per line, Twc poses (SaveTrajectoryTUM)."""
    with open(path, "w") as f:
        for t, twc in traj:
            q = _quat_from_mat(twc[:3, :3])
            p = twc[:3, 3]
            f.write(f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_trajectory_kitti(path: str, traj: Sequence[Tuple[float, np.ndarray]]):
    """12 values of the 3x4 Twc per line (SaveTrajectoryKITTI)."""
    with open(path, "w") as f:
        for _, twc in traj:
            row = twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_trajectory_euroc(path: str, traj: Sequence[Tuple[float, np.ndarray]]):
    """`t_ns,tx,ty,tz,qw,qx,qy,qz` (SaveTrajectoryEuRoC csv flavour)."""
    with open(path, "w") as f:
        f.write("#timestamp [ns], p_x, p_y, p_z, q_w, q_x, q_y, q_z\n")
        for t, twc in traj:
            q = _quat_from_mat(twc[:3, :3])
            p = twc[:3, 3]
            f.write(f"{int(t*1e9)},{p[0]:.7f},{p[1]:.7f},{p[2]:.7f},"
                    f"{q[3]:.7f},{q[0]:.7f},{q[1]:.7f},{q[2]:.7f}\n")


def load_trajectory_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            t, p, q = v[0], np.array(v[1:4]), np.array(v[4:8])
            qx, qy, qz, qw = q
            rot = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
            ])
            twc = np.eye(4)
            twc[:3, :3] = rot
            twc[:3, 3] = p
            out.append((t, twc))
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def keyframe_trajectory(ms, imu_body=False,
                        time_base: float = 0.0) -> List[Tuple[float, np.ndarray]]:
    """Extract the KF trajectory from a MapState (SaveKeyFrameTrajectoryTUM),
    sorted by timestamp. `time_base` re-bases the device-side f32 offset
    stamps back to the session's absolute f64 epoch."""
    valid = _host(ms.kf_valid)
    times = _host(ms.kf_time).astype(np.float64) + float(time_base)
    rots = _host(ms.kf_rot)
    ts = _host(ms.kf_t)
    entries = []
    for k in np.argsort(times):
        if not valid[k]:
            continue
        rwc = rots[k].T
        twc = np.eye(4)
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ ts[k]
        entries.append((float(times[k]), twc))
    return entries
