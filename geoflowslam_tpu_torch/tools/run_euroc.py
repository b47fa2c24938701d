"""EuRoC MAV driver of the port: monocular, mono-inertial, stereo and
stereo-inertial (the counterpart of the JAX package's examples/run_euroc.py
and of the reference's mono_inertial_euroc / stereo_inertial_euroc).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 geoflowslam_tpu_torch/tools/run_euroc.py <seq_dir> \
        [--mode mono|mono_imu|stereo|stereo_imu] [--settings euroc.yaml] \
        [--out results_euroc] [--max-frames N] [--device cuda|cpu]

Reads mav0/cam0 (and cam1 in the stereo modes) and mav0/imu0. The default
intrinsics are the EuRoC cam0 values with its radtan distortion; --settings
takes them from a reference YAML instead (io/yaml_compat; a dual-KB8 rig
with Camera2.* blocks runs track_stereo_fisheye). `shutdown` writes the
trajectories, map.html and the timers' files to --out. The device is CUDA
unless --device cpu is given; a CUDA device without CUDA raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import torch  # noqa: E402

from geoflowslam_tpu_torch.config import (FrameConfig, ImuConfig,  # noqa
                                          OrbConfig, SystemConfig)
from geoflowslam_tpu_torch.io import datasets as D  # noqa: E402
from geoflowslam_tpu_torch.io.native_loader import FrameLoader  # noqa: E402
from geoflowslam_tpu_torch.io.yaml_compat import \
    system_config_from_yaml  # noqa: E402
from geoflowslam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--mode", default="mono_imu",
                    choices=["mono", "mono_imu", "stereo", "stereo_imu"])
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="results_euroc")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def euroc_config(mode: str) -> SystemConfig:
    """EuRoC cam0 (458.654, 457.296, 367.215, 248.375; 752x480, radtan
    distortion), as the reference's euroc yamls give it."""
    orb = OrbConfig(n_features=1000, n_levels=8, height=480, width=752)
    imu_cfg = (ImuConfig(freq=200.0, noise_gyro=1.7e-4, noise_acc=2e-3,
                         walk_gyro=1.9e-5, walk_acc=3e-3)
               if "imu" in mode else None)
    fc = FrameConfig(orb=orb, bf=458.654 * 0.11,
                     dist_params=(-0.2834, 0.0739, 1.99e-4, 1.76e-5, 0.0))
    return SystemConfig(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                        bf=458.654 * 0.11, frame=fc, imu=imu_cfg,
                        sensor="mono" if "mono" in mode else "rgbd")


def main(argv=None) -> dict:
    """Run the driver; returns {"slam", "native", "wall_s"}."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    frames, imu = D.load_euroc(args.sequence, "cam0")
    frames_r = None
    if "stereo" in args.mode:
        frames_r, _ = D.load_euroc(args.sequence, "cam1")
    if args.max_frames:
        frames = frames[: args.max_frames]

    if args.settings:
        cfg, _ = system_config_from_yaml(
            args.settings, sensor="mono" if "mono" in args.mode else "rgbd")
        if "imu" not in args.mode:
            cfg = dataclasses.replace(cfg, imu=None)
    else:
        cfg = euroc_config(args.mode)

    slam = SlamSystem(cfg, dev)
    size = dict(height=cfg.frame.orb.height, width=cfg.frame.orb.width)
    loader = FrameLoader([f.rgb_path for f in frames], None, **size)
    loader_r = None
    if frames_r is not None:
        loader_r = FrameLoader([f.rgb_path for f in frames_r], None, **size)
        it_r = iter(loader_r)
    t0 = time.time()
    last_t = frames[0].time
    for idx, gray, _ in loader:
        fr = frames[idx]
        has_imu = "imu" in args.mode and idx > 0 and cfg.imu is not None
        if has_imu:
            imu_in = D.imu_between(imu, last_t, fr.time,
                                   cfg.imu.max_samples_per_frame)
        if "stereo" in args.mode:
            _, gray_r, _ = next(it_r)
            # dual-KB8 rigs (TUM-VI-style settings with Camera2.* blocks)
            # go through the stereo-fisheye matcher, rectified rigs through
            # the SAD search
            if cfg.stereo_fisheye is not None:
                if has_imu:
                    slam.track_stereo_fisheye_inertial(gray, gray_r, *imu_in,
                                                       fr.time)
                else:
                    slam.track_stereo_fisheye(gray, gray_r, fr.time)
            elif has_imu:
                slam.track_stereo_inertial(gray, gray_r, *imu_in, fr.time)
            else:
                slam.track_stereo(gray, gray_r, fr.time)
        elif has_imu:
            slam.track_monocular_inertial(gray, *imu_in, fr.time)
        else:
            slam.track_monocular(gray, fr.time)
        last_t = fr.time
        if idx % 100 == 0:
            print(f"[{idx}/{len(frames)}] {slam.map_stats()}", flush=True)
    loader.close()
    if loader_r is not None:
        loader_r.close()

    wall = time.time() - t0
    print(f"done: {len(frames)} frames in {wall:.1f}s "
          f"({len(frames) / wall:.1f} FPS) {slam.map_stats()}")
    slam.shutdown(args.out)
    return dict(slam=slam, native=loader.native, wall_s=wall)


if __name__ == "__main__":
    main()
