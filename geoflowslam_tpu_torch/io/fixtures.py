"""Synthetic dataset exporter: TUM-RGBD / EuRoC-mav0 shaped directories
(port of geoflowslam_tpu/io/fixtures.py, rendered by the port's
io/synthetic on the `device` each exporter is given).

Writes the exact on-disk layouts the dataset drivers consume — the same
glue the reference binaries exercise on every run
(Examples/RGB-D-Inertial/rgbd_inertial.cc:44-86 association
+ imu.txt parsing; Examples/Monocular-Inertial/mono_inertial_euroc.cc mav0
csv layout) — generated from the synthetic world so driver-main e2e tests
and demos run without external datasets.

Layouts:
  TUM:   rgb/<t>.png (8-bit gray), depth/<t>.png (16-bit, 5000 steps/m),
         assoc.txt, imu/imu.txt (t wx wy wz ax ay az), groundtruth.txt,
         settings.yaml (reference-style keys for io/yaml_compat).
  EuRoC: mav0/cam0/data/<ns>.png + data.csv, mav0/imu0/data.csv
         (ns, wx, wy, wz, ax, ay, az), groundtruth.txt.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from geoflowslam_tpu_torch.io.synthetic import (GRAVITY, Camera,
                                                SyntheticSequence,
                                                SyntheticWorld,
                                                smooth_trajectory)
from geoflowslam_tpu_torch.math import lie


# ---------------------------------------------------------------------------
# Minimal PNG writer (filter 0 rows; gray 8-bit / gray 16-bit big-endian) —
# both the python reader (io/datasets._read_png_gray) and the native decoder
# (native/frame_loader.cpp) accept this subset.
# ---------------------------------------------------------------------------

def write_png_gray(path: str, img: np.ndarray):
    """img: [H,W] uint8 or uint16 (16-bit written big-endian)."""
    img = np.asarray(img)
    assert img.ndim == 2, img.shape
    h, w = img.shape
    if img.dtype == np.uint16:
        bitd, payload = 16, img.astype(">u2").tobytes()
        stride = w * 2
    else:
        bitd, payload = 8, img.astype(np.uint8).tobytes()
        stride = w
    raw = b"".join(b"\x00" + payload[y * stride:(y + 1) * stride]
                   for y in range(h))

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, bitd, 0, 0, 0, 0)  # gray, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _pose_lines(ts, rot_cw, t_cw):
    """TUM groundtruth rows `t tx ty tz qx qy qz qw` (camera-to-world)."""
    lines = []
    for t, rc, tc in zip(ts, rot_cw, t_cw):
        rwc = np.asarray(rc).T
        p = -rwc @ np.asarray(tc)
        q = lie.quat_from_mat(torch.from_numpy(rwc.copy())).numpy()  # w,x,y,z
        lines.append(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    return lines


def _render_sequence(n_frames, fps, width, height, imu_rate, t0, *,
                     device):
    """Render frames + IMU from the smooth synthetic trajectory on `device`
    (the tests use 320x240 on the CPU); every array comes back to the
    host."""
    cam = Camera(fx=width * 0.625, fy=width * 0.625, cx=width / 2,
                 cy=height / 2, width=width, height=height)
    world = SyntheticWorld(cam, device=device)
    seq = SyntheticSequence(world, fps=fps, imu_rate=imu_rate)
    frames = []
    for i in range(n_frames):
        t = i / fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t)
        frames.append((t0 + t, gray.cpu().numpy(), depth.cpu().numpy(),
                       rot_cw.cpu().numpy(), t_cw.cpu().numpy()))
    # IMU samples over the whole span at imu_rate, from the analytic model
    # (float32, as the JAX package evaluates it)
    n_imu = int(n_frames / fps * imu_rate)
    ts_imu = (np.arange(n_imu) + 0.5) / imu_rate
    rot_wb, _, _, a_w, w_b = [x.numpy() for x in smooth_trajectory(
        torch.from_numpy(ts_imu.astype(np.float32)))]
    acc_b = np.einsum("nij,nj->ni", np.swapaxes(rot_wb, -1, -2),
                      a_w - np.asarray(GRAVITY))
    imu_rows = np.column_stack([t0 + ts_imu, w_b, acc_b])
    return cam, frames, imu_rows


def export_tum_rgbd(out_dir: str, n_frames: int = 30, fps: float = 10.0,
                    width: int = 320, height: int = 240,
                    imu_rate: float = 200.0, t0: float = 1.4e9,
                    n_features: int = 300, depth_steps: float = 5000.0,
                    n_levels: int = 4, *, device):
    """Write a TUM-RGBD-shaped sequence directory + settings.yaml; returns
    (seq_dir, settings_path, assoc_path). `n_levels` is the settings'
    ORBextractor.nLevels."""
    cam, frames, imu_rows = _render_sequence(n_frames, fps, width, height,
                                             imu_rate, t0, device=device)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "imu"), exist_ok=True)
    assoc, gt_ts, gt_r, gt_t = [], [], [], []
    for (t, gray, depth, rot_cw, t_cw) in frames:
        name = f"{t:.6f}.png"
        write_png_gray(os.path.join(out_dir, "rgb", name),
                       np.clip(gray, 0, 255).astype(np.uint8))
        write_png_gray(os.path.join(out_dir, "depth", name),
                       np.clip(depth * depth_steps, 0, 65535)
                       .astype(np.uint16))
        assoc.append(f"{t:.6f} rgb/{name} {t:.6f} depth/{name}")
        gt_ts.append(t); gt_r.append(rot_cw); gt_t.append(t_cw)
    assoc_path = os.path.join(out_dir, "assoc.txt")
    with open(assoc_path, "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(out_dir, "imu", "imu.txt"), "w") as f:
        f.write("# t wx wy wz ax ay az\n")
        for row in imu_rows:
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("\n".join(_pose_lines(gt_ts, gt_r, gt_t)) + "\n")
    settings = os.path.join(out_dir, "settings.yaml")
    with open(settings, "w") as f:
        f.write(f"""%YAML:1.0
Camera.type: "PinHole"
Camera.fx: {cam.fx}
Camera.fy: {cam.fy}
Camera.cx: {cam.cx}
Camera.cy: {cam.cy}
Camera.width: {width}
Camera.height: {height}
Camera.fps: {fps}
Camera.bf: {cam.fx * 0.1}
RGBD.DepthMapFactor: {depth_steps}
Stereo.ThDepth: 40.0
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
IMU.Frequency: {imu_rate}
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.InitMinKFs: 4
IMU.InitMinTime: 0.5
""")
    return out_dir, settings, assoc_path


def export_euroc(out_dir: str, n_frames: int = 40, fps: float = 10.0,
                 width: int = 320, height: int = 240,
                 imu_rate: float = 200.0, t0: float = 1.4e9, *,
                 device):
    """Write an EuRoC-mav0-shaped sequence directory; returns seq_dir."""
    cam, frames, imu_rows = _render_sequence(n_frames, fps, width, height,
                                             imu_rate, t0, device=device)
    cam_dir = os.path.join(out_dir, "mav0", "cam0", "data")
    imu_dir = os.path.join(out_dir, "mav0", "imu0")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(imu_dir, exist_ok=True)
    rows, gt_ts, gt_r, gt_t = [], [], [], []
    for (t, gray, depth, rot_cw, t_cw) in frames:
        ns = int(round(t * 1e9))
        name = f"{ns}.png"
        write_png_gray(os.path.join(cam_dir, name),
                       np.clip(gray, 0, 255).astype(np.uint8))
        rows.append(f"{ns},{name}")
        gt_ts.append(t); gt_r.append(rot_cw); gt_t.append(t_cw)
    with open(os.path.join(out_dir, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for row in imu_rows:
            ns = int(round(row[0] * 1e9))
            f.write(f"{ns}," + ",".join(f"{v:.9f}" for v in row[1:]) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("\n".join(_pose_lines(gt_ts, gt_r, gt_t)) + "\n")
    # settings matching the rendered camera (the euroc driver's default
    # intrinsics are the real EuRoC cam0's — the fixture is smaller)
    settings = os.path.join(out_dir, "settings.yaml")
    with open(settings, "w") as f:
        f.write(f"""%YAML:1.0
Camera.type: "PinHole"
Camera.fx: {cam.fx}
Camera.fy: {cam.fy}
Camera.cx: {cam.cx}
Camera.cy: {cam.cy}
Camera.width: {width}
Camera.height: {height}
Camera.fps: {fps}
Camera.bf: {cam.fx * 0.1}
ORBextractor.nFeatures: 300
ORBextractor.nLevels: 4
""")
    return out_dir
