"""TUM RGB-D(-inertial) dataset driver of the port (the counterpart of the
JAX package's examples/run_rgbd_tum.py and of the reference's rgbd_tum /
rgbd_inertial binaries).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 geoflowslam_tpu_torch/tools/run_rgbd_tum.py <settings.yaml> \
        <sequence_dir> <association.txt> [--out out_dir] [--imu] [--odom] \
        [--atlas save.npz] [--load-atlas in.npz] [--max-frames N] \
        [--device cuda|cpu]

The settings YAML gives the SystemConfig (io/yaml_compat, sensor "rgbd"),
the association file the (rgb, depth) pairs; the images are decoded ahead
by io/native_loader.FrameLoader (the native decoder when `g++` can build
it, else Python). --imu slices `imu/imu.txt` between frames and tracks with
track_rgbd_inertial, --odom queues `imu/odom.txt` velocities. At the end
`shutdown` writes CameraTrajectory.txt, KeyFrameTrajectory.txt, map.html and
the timers' files to --out, and --atlas saves the map. The device is CUDA
unless --device cpu is given; a CUDA device without CUDA raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import torch  # noqa: E402

from geoflowslam_tpu_torch.io import datasets as D  # noqa: E402
from geoflowslam_tpu_torch.io.native_loader import FrameLoader  # noqa: E402
from geoflowslam_tpu_torch.io.yaml_compat import \
    system_config_from_yaml  # noqa: E402
from geoflowslam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("association")
    ap.add_argument("--out", default="results")
    ap.add_argument("--imu", action="store_true")
    ap.add_argument("--odom", action="store_true")
    ap.add_argument("--atlas", default=None, help="save atlas checkpoint")
    ap.add_argument("--load-atlas", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the driver; returns {"slam", "native" (the decoder that ran),
    "frame_ms" (host wall time of each track call, synchronized),
    "wall_s"}."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg, _ = system_config_from_yaml(args.settings, sensor="rgbd")
    frames = D.load_tum_associations(args.sequence, args.association)
    if args.max_frames:
        frames = frames[: args.max_frames]
    imu = None
    if args.imu:
        imu = D.load_imu_txt(os.path.join(args.sequence, "imu", "imu.txt"))
    odom = None
    if args.odom:
        odom = D.load_odom_txt(os.path.join(args.sequence, "imu",
                                            "odom.txt"))

    slam = SlamSystem(cfg, dev)
    if args.load_atlas:
        slam.load_atlas(args.load_atlas)

    loader = FrameLoader([f.rgb_path for f in frames],
                         [f.depth_path for f in frames],
                         height=cfg.frame.orb.height,
                         width=cfg.frame.orb.width, depth_scale=1.0)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    frame_ms = []
    t0 = time.time()
    last_t = frames[0].time
    oi = 0
    for idx, gray, depth in loader:
        fr = frames[idx]
        if odom is not None:
            while oi + 1 < len(odom) and odom[oi + 1][0] <= fr.time:
                oi += 1
            slam.set_odom(odom[oi][1:4])
        ts = time.perf_counter()
        if imu is not None and cfg.imu is not None and idx > 0:
            acc, gyro, dts = D.imu_between(imu, last_t, fr.time,
                                           cfg.imu.max_samples_per_frame)
            # build_frame applies cfg.frame.depth_map_factor itself
            slam.track_rgbd_inertial(gray, depth, acc, gyro, dts, fr.time)
        else:
            slam.track_rgbd(gray, depth, fr.time)
        sync()
        frame_ms.append((time.perf_counter() - ts) * 1e3)
        last_t = fr.time
        if idx % 50 == 0:
            print(f"[{idx}/{len(frames)}] {slam.map_stats()}", flush=True)
    loader.close()

    wall = time.time() - t0
    print(f"done: {len(frames)} frames in {wall:.1f}s "
          f"({len(frames) / wall:.1f} FPS) {slam.map_stats()} "
          f"decoder {'native' if loader.native else 'python'}")
    slam.shutdown(args.out)
    if args.atlas:
        slam.save_atlas(args.atlas)
    print(f"trajectories + stats written to {args.out}")
    return dict(slam=slam, native=loader.native, frame_ms=frame_ms,
                wall_s=wall)


if __name__ == "__main__":
    main()
