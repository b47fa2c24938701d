"""Reference settings-YAML compatibility layer (port of
geoflowslam_tpu/io/yaml_compat.py; it builds the port's config dataclasses).

Parses the reference's OpenCV-FileStorage YAML configs (the exact files under
the reference's Examples/*/config and script/run_orbslam/*/config — flat
`Section.key: value` keys with a `%YAML:1.0` header and occasional
`!!opencv-matrix` blocks) into a SystemConfig, mirroring the typed Settings
reader (src/Settings.cc, include/Settings.h:81-160) and the
GeoFlow-specific keys (SURVEY.md §5: UseOpticalFlow, UseClahe, UseICP,
ICPMethod, UseRobotOdom, LKWindowSize, MASK_THRESHOLD, TimeRecentlyLost,
InsertKFsWhenLost, IMU.*, LidarMapping.*, ...).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

from geoflowslam_tpu_torch.config import (FrameConfig, ImuConfig, OrbConfig,
                                          StereoFisheyeConfig, SystemConfig)


def parse_opencv_yaml(path: str) -> Dict[str, Any]:
    """Minimal OpenCV-YAML parser: flat scalars + opencv-matrix blocks."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#")[0].rstrip()
        i += 1
        if not line or line.startswith("%YAML") or line.strip() == "---":
            continue
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.*)$", line.strip())
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("!!opencv-matrix") or val == "":
            # matrix block: rows/cols/dt/data
            rows = cols = None
            data = []
            while i < len(lines):
                s = lines[i].strip()
                if re.match(r"^[A-Za-z0-9_.]+:", s) and not any(
                        s.startswith(p) for p in ("rows:", "cols:", "dt:", "data:")):
                    break
                i += 1
                if s.startswith("rows:"):
                    rows = int(s.split(":")[1])
                elif s.startswith("cols:"):
                    cols = int(s.split(":")[1])
                elif s.startswith("data:"):
                    buf = s.split(":", 1)[1]
                    while "]" not in buf and i < len(lines):
                        buf += lines[i]
                        i += 1
                    nums = re.findall(r"[-+0-9.eE]+", buf)
                    data = [float(x) for x in nums]
            if rows and cols and data:
                out[key] = np.asarray(data, np.float32).reshape(rows, cols)
            continue
        # scalar
        v = val.strip().strip('"')
        try:
            out[key] = int(v)
        except ValueError:
            try:
                out[key] = float(v)
            except ValueError:
                out[key] = v
    return out


def system_config_from_yaml(path: str, sensor: Optional[str] = None,
                            **overrides):
    """Build a SystemConfig (+ FrameConfig/OrbConfig/ImuConfig) from a
    reference YAML file. `sensor` overrides auto-detection."""
    y = parse_opencv_yaml(path)

    def get(key, default):
        return y.get(key, default)

    fx = float(get("Camera1.fx", get("Camera.fx", 400.0)))
    fy = float(get("Camera1.fy", get("Camera.fy", 400.0)))
    cx = float(get("Camera1.cx", get("Camera.cx", 320.0)))
    cy = float(get("Camera1.cy", get("Camera.cy", 240.0)))
    width = int(get("Camera.width", 640))
    height = int(get("Camera.height", 480))
    bf = float(get("Camera.bf", get("Camera.bf_", 40.0)))
    fps = float(get("Camera.fps", 30.0))
    depth_factor = float(get("RGBD.DepthMapFactor", get("DepthMapFactor", 1.0)))
    th_depth = float(get("Stereo.ThDepth", get("ThDepth", 40.0)))

    orb = OrbConfig(
        n_features=int(get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(get("ORBextractor.nLevels", 8)),
        ini_th_fast=float(get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(get("ORBextractor.minThFAST", 7)),
        height=height, width=width,
    )
    use_of = bool(get("UseOpticalFlow", 0))
    cam_type = str(get("Camera.type", get("Camera1.type", "PinHole")))
    if "KannalaBrandt" in cam_type:
        camera_model = "kb8"
        dist = tuple(float(get(f"Camera1.k{i}", get(f"Camera.k{i}", 0.0)))
                     for i in (1, 2, 3, 4))
    else:
        camera_model = "pinhole"
        k1 = float(get("Camera1.k1", get("Camera.k1", 0.0)))
        if k1 != 0.0:
            dist = (k1,
                    float(get("Camera1.k2", get("Camera.k2", 0.0))),
                    float(get("Camera1.p1", get("Camera.p1", 0.0))),
                    float(get("Camera1.p2", get("Camera.p2", 0.0))),
                    float(get("Camera1.k3", get("Camera.k3", 0.0))))
        else:
            dist = ()
    frame = FrameConfig(
        orb=orb,
        use_clahe=bool(get("UseClahe", 0)),
        bf=bf,
        depth_map_factor=1.0 / depth_factor if depth_factor > 1.0 else 1.0,
        n_of_slots=256 if use_of else 0,
        camera_model=camera_model,
        dist_params=dist,
    )

    imu_cfg = None
    if "IMU.NoiseGyro" in y or "IMU.Frequency" in y:
        t_bc = y.get("IMU.T_b_c1", y.get("Tbc", np.eye(4, dtype=np.float32)))
        imu_cfg = ImuConfig(
            freq=float(get("IMU.Frequency", 200.0)),
            noise_gyro=float(get("IMU.NoiseGyro", 1.7e-4)),
            noise_acc=float(get("IMU.NoiseAcc", 2e-3)),
            walk_gyro=float(get("IMU.GyroWalk", 1.9e-5)),
            walk_acc=float(get("IMU.AccWalk", 3e-3)),
            t_bc=np.asarray(t_bc, np.float32).reshape(4, 4),
            imu_method=int(get("IMU.IMUMethod", 0)),
        )

    if sensor is None:
        sensor = "rgbd" if depth_factor != 1.0 or "RGBD.DepthMapFactor" in y \
            else "mono"

    # dual-KB8 stereo rig (TUM-VI-style configs: Camera2.* + Stereo.T_c1_c2
    # + Camera*.overlappingBegin/End, parsed by the reference's
    # Settings::readCamera2, src/Settings.cc)
    stereo_fisheye = None
    if camera_model == "kb8" and "Camera2.fx" in y:
        t_c1_c2 = np.asarray(y.get("Stereo.T_c1_c2", np.eye(4)),
                             np.float32).reshape(4, 4)
        stereo_fisheye = StereoFisheyeConfig(
            params_r=tuple(float(get(f"Camera2.{k}", 0.0))
                           for k in ("fx", "fy", "cx", "cy",
                                     "k1", "k2", "k3", "k4")),
            r_lr=tuple(t_c1_c2[:3, :3].reshape(-1).tolist()),
            t_lr=tuple(t_c1_c2[:3, 3].tolist()),
            lapping_l=(float(get("Camera1.overlappingBegin", 0.0)),
                       float(get("Camera1.overlappingEnd", 1e9))),
            lapping_r=(float(get("Camera2.overlappingBegin", 0.0)),
                       float(get("Camera2.overlappingEnd", 1e9))),
        )
        sensor = "stereo"

    cfg = SystemConfig(
        stereo_fisheye=stereo_fisheye,
        fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, frame=frame, sensor=sensor,
        imu=imu_cfg,
        close_depth=bf / fx * th_depth if th_depth > 0 else 0.0,
        use_of=use_of,
        use_icp=bool(get("UseICP", 0)),
        icp_method="ndt" if str(get("ICPMethod", "GICP")).upper() == "NDT" else "gicp",
        use_odom=bool(get("UseRobotOdom", 0)),
        use_lidar=bool(get("UsePointCloudObs", 0)),
        use_gms_init=bool(get("UseGMSInit", 0)),
        time_recently_lost=float(get("TimeRecentlyLost", 5.0)),
        insert_kfs_when_lost=bool(get("InsertKFsWhenLost", 1)),
        r_odom_cam=(tuple(np.asarray(y["T_odom_w"], np.float32)
                          .reshape(-1)[:9].tolist())
                    if "T_odom_w" in y else None),
    )
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, y
