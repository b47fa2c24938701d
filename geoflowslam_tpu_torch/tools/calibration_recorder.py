"""Calibration dataset recorder of the port (EuRoC directory layout; the
counterpart of the JAX package's tools/calibration_recorder.py).

Role of the reference's Examples/Calibration/recorder_realsense_*.cc: grab
a camera+IMU stream and write the EuRoC-style tree that calibration tools
(Kalibr, tools/process_imu.py) consume:

    out/
      cam0/data/<stamp_ns>.png     cam0/times.txt
      imu0/data.csv                (stamp_ns, wx, wy, wz, ax, ay, az)

`--source synthetic` records the analytic synthetic rig (io/synthetic: a
320x240 camera in the textured room, rendered on --device) with white noise
and a random-walk bias on the IMU, so that the chain recorder ->
process_imu -> ImuConfig YAML runs without hardware. Static by default (the
IMU-calibration pose: the gyro sees only noise, the accelerometer gravity);
--moving records the smooth trajectory instead. Run from the root of a
checkout:

    python3 geoflowslam_tpu_torch/tools/calibration_recorder.py \
        --out calib [--seconds 20] [--fps 10] [--imu-rate 200] [--moving] \
        [--device cuda|cpu]
    python3 tools/process_imu.py calib

The device is CUDA unless --device cpu is given; a CUDA device without
CUDA raises.
"""
from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from geoflowslam_tpu_torch.io.fixtures import write_png_gray  # noqa: E402
from geoflowslam_tpu_torch.io.synthetic import (GRAVITY, Camera,  # noqa
                                                SyntheticSequence,
                                                SyntheticWorld,
                                                smooth_trajectory)

__all__ = ["write_png_gray", "record_synthetic", "main"]

IMU_HEADER = ("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y,w_RS_S_z,"
              "a_RS_S_x [m s^-2],a_RS_S_y,a_RS_S_z\n")


def record_synthetic(out: str, seconds: float, fps: float, imu_rate: float,
                     noise_gyro=1.7e-4, noise_acc=2e-3,
                     walk_gyro=1.9e-5, walk_acc=3e-3, seed=0,
                     static: bool = True, device="cuda") -> None:
    """Record the synthetic rig with IMU white noise (density noise_*) and
    a bias random walk (density walk_*), drawn from default_rng(seed) in
    the JAX tool's order, so that the Allan analysis has something true to
    recover. Frames and the trajectory are evaluated on `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("record_synthetic: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    cam = Camera(width=320, height=240, fx=200.0, fy=200.0, cx=160.0,
                 cy=120.0)
    seq = SyntheticSequence(SyntheticWorld(cam, device=dev), fps=fps,
                            imu_rate=imu_rate)
    rng = np.random.default_rng(seed)

    cam_dir = os.path.join(out, "cam0", "data")
    imu_dir = os.path.join(out, "imu0")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(imu_dir, exist_ok=True)

    times = []
    n_frames = int(seconds * fps)
    for i in range(n_frames):
        t = i / fps
        stamp_ns = int(t * 1e9)
        gray = seq.frame(t)[0].cpu().numpy()
        write_png_gray(os.path.join(cam_dir, f"{stamp_ns}.png"),
                       np.clip(gray, 0, 255).astype(np.uint8))
        times.append(stamp_ns)
    with open(os.path.join(out, "cam0", "times.txt"), "w") as f:
        f.write("\n".join(str(t) for t in times) + "\n")

    # continuous IMU at imu_rate, the whole stream in one trajectory eval
    dt = 1.0 / imu_rate
    n_imu = int(seconds * imu_rate)
    sq = np.sqrt(imu_rate)          # discrete sigma = density * sqrt(rate)
    tt = (np.arange(n_imu) + 0.5) * dt
    if static:
        gyro_b = np.zeros((n_imu, 3))
        acc_b = np.broadcast_to(-GRAVITY, (n_imu, 3)).copy()
    else:
        rot_wb, _, _, a_w, w_body = (x.cpu().numpy() for x in
                                     smooth_trajectory(torch.as_tensor(
                                         tt, dtype=torch.float32,
                                         device=dev)))
        acc_b = np.einsum("sij,sj->si", np.swapaxes(rot_wb, -1, -2),
                          a_w - GRAVITY)
        gyro_b = w_body
    bg = np.cumsum(rng.normal(0, walk_gyro / sq, (n_imu, 3)), axis=0)
    ba = np.cumsum(rng.normal(0, walk_acc / sq, (n_imu, 3)), axis=0)
    g_all = gyro_b + bg + rng.normal(0, noise_gyro * sq, (n_imu, 3))
    a_all = acc_b + ba + rng.normal(0, noise_acc * sq, (n_imu, 3))
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write(IMU_HEADER)
        for k in range(n_imu):
            g, a = g_all[k], a_all[k]
            f.write(f"{int(tt[k]*1e9)},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                    f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}\n")
    print(f"recorded {n_frames} frames + {n_imu} IMU samples -> {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--imu-rate", type=float, default=200.0)
    ap.add_argument("--source", default="synthetic",
                    choices=["synthetic"])  # hardware sources plug in here
    ap.add_argument("--moving", action="store_true",
                    help="record the moving rig (SLAM input) instead of the "
                         "static IMU-calibration pose")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    record_synthetic(args.out, args.seconds, args.fps, args.imu_rate,
                     static=not args.moving, device=args.device)


if __name__ == "__main__":
    main()
