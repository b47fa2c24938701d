"""Synthetic-room driver of the port: an end-to-end run and its ATE with no
data (the counterpart of the JAX package's examples/run_synthetic.py).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 geoflowslam_tpu_torch/tools/run_synthetic.py \
        [--mode rgbd|mono|rgbd_inertial|stereo] [--frames 100] [--fps 30] \
        [--out results_synth] [--width 640] [--height 480] [--t0 0] \
        [--device cuda|cpu]

The camera flies io/synthetic's smooth trajectory through the textured
room (fx = 0.625 x width, bf = 0.1 fx); stereo renders the right image
0.1 m to the right. Prints the frame rate, the map statistics, the ATE
(7-DoF for mono) and the RPE, and `shutdown` writes the trajectories,
map.html and the timers' files to --out. `--t0` stamps the first frame
(1.4e9 exercises epoch-scale stamps as TUM and EuRoC carry them). The device
is CUDA unless --device cpu is given; a CUDA device without CUDA raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from geoflowslam_tpu_torch.config import (FrameConfig, ImuConfig,  # noqa
                                          OrbConfig, SystemConfig)
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe  # noqa: E402
from geoflowslam_tpu_torch.io.synthetic import (Camera,  # noqa: E402
                                                SyntheticSequence,
                                                SyntheticWorld)
from geoflowslam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="rgbd",
                    choices=["rgbd", "mono", "rgbd_inertial", "stereo"])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--out", default="results_synth")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--t0", type=float, default=0.0,
                    help="timestamp of the first frame (e.g. 1.4e9 for "
                         "epoch-scale stamps like TUM/EuRoC)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sequence; returns the ATE and RPE dicts and the map stats."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    w, h = args.width, args.height
    cam = Camera(fx=w * 0.625, fy=w * 0.625, cx=w / 2, cy=h / 2, width=w,
                 height=h)
    orb = OrbConfig(n_features=1000 if w >= 640 else 400,
                    n_levels=8 if w >= 640 else 4, height=h, width=w)
    cfg = SystemConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.fx * 0.1,
        frame=FrameConfig(orb=orb, bf=cam.fx * 0.1),
        imu=ImuConfig() if args.mode == "rgbd_inertial" else None,
        sensor="mono" if args.mode == "mono" else "rgbd")
    world = SyntheticWorld(cam, device=dev)
    seq = SyntheticSequence(world, fps=args.fps)
    slam = SlamSystem(cfg, dev)

    gt, last_t = [], 0.0
    t_start = time.time()
    for i in range(args.frames):
        t = args.t0 + i / args.fps
        gray, depth, (rot_cw, t_cw) = seq.frame(t - args.t0)
        if args.mode == "mono":
            slam.track_monocular(gray, t)
        elif args.mode == "rgbd_inertial" and i > 0:
            acc, gyro, dts = seq.imu_between(last_t - args.t0, t - args.t0,
                                             32)
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, t)
        elif args.mode == "stereo":
            t_rw = t_cw + torch.tensor([-0.1, 0.0, 0.0], device=dev)
            gray_r, _ = world.render(rot_cw, t_rw)
            slam.track_stereo(gray, gray_r, t)
        else:
            slam.track_rgbd(gray, depth, t)
        last_t = t
        rwc = rot_cw.cpu().numpy().astype(np.float64).T
        twc = np.eye(4)
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ t_cw.cpu().numpy().astype(np.float64)
        gt.append((t, twc))

    wall = time.time() - t_start
    st = slam.map_stats()
    m = ate_rmse(slam.trajectory, gt, with_scale=(args.mode == "mono"))
    r = rpe(slam.trajectory, gt)
    print(f"{args.frames} frames in {wall:.1f}s "
          f"({args.frames / wall:.1f} FPS)")
    print(f"map: {st}")
    print(f"ATE rmse {m['ate_rmse'] * 100:.2f} cm | RPE "
          f"{r['rpe_trans'] * 100:.2f} cm / {r['rpe_rot_deg']:.3f} deg")
    os.makedirs(args.out, exist_ok=True)
    slam.shutdown(args.out)
    return dict(ate=m, rpe=r, stats=st, slam=slam)


if __name__ == "__main__":
    main()
