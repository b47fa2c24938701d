"""Time whole frames through SlamSystem on the card: ms a frame on the RGB-D
path (the default SystemConfig, 640x480, 1000 features, 8 levels) and on
the RGB-D-inertial path at bench.py's configuration (chip_smoke.
inertial_config), split into frames that inserted a keyframe and the others,
and the others by imu_mode.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 geoflowslam_tpu_torch/tools/time_frames.py
    python3 geoflowslam_tpu_torch/tools/time_frames.py --compare OLD

It imports the package and chip_smoke.py of the current directory and uses
only entries that every tree since the inertial path has, so the same file,
run from the root of an older checkout, times that checkout. --compare OLD
runs an older checkout unpacked at OLD (a directory that .gitignore lists)
and this one in the order old, this, this, old, each a process of its own
under a line "== <root>", so that both trees see the same card and host.

Each process renders the room's frames on the card first (30 fps; 200 Hz
IMU for the inertial run), then tracks RGBD_FRAMES and INERTIAL_FRAMES of
them, each frame ending in torch.cuda.synchronize(), and prints one JSON
line per path: the median and p90 ms of the frames without a keyframe (by
imu_mode on the inertial path), of the keyframe frames, and their counts.
The first line is the card's name and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

RGBD_FRAMES = 60
INERTIAL_FRAMES = 90     # the IMU initializes at ~1.1 s: ~55 frames after


def _stats(ms):
    if not ms:
        return None
    return dict(median=round(float(np.median(ms)), 2),
                p90=round(float(np.percentile(ms, 90)), 2), n=len(ms))


def _run(tag, slam, frames, step):
    import torch
    plain, kf = {}, []
    for i, f in enumerate(frames):
        before = dict(getattr(slam, "imu_modes", {}))
        kfs = slam._gen_counter
        t0 = time.perf_counter()
        step(slam, i, f)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i < 2:
            continue        # the initialization and the first tracked frame
        if slam._gen_counter != kfs:
            kf.append(ms)
            continue
        mode = next((m for m, n in slam.imu_modes.items()
                     if n != before.get(m, 0)), "rgbd")
        plain.setdefault(mode, []).append(ms)
    print(json.dumps({"path": tag, "state": slam.state.name,
                      "no_kf": {m: _stats(v) for m, v in plain.items()},
                      "kf": _stats(kf)}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "no card",
          flush=True)
    if args[:1] == ["--compare"] and len(args) == 2:
        here = os.getcwd()
        old = os.path.abspath(args[1])
        for root in (old, here, here, old):
            print(f"== {root}", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__)],
                           cwd=root, check=True,
                           env={**os.environ, "PYTHONPATH": root})
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_frames: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as C
    from geoflowslam_tpu_torch import kernels
    from geoflowslam_tpu_torch.config import SystemConfig
    from geoflowslam_tpu_torch.io import feed_codec as FC
    from geoflowslam_tpu_torch.pipeline.system import SlamSystem
    t0 = time.perf_counter()
    kernels.load()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 1)}),
          flush=True)
    dev = torch.device("cuda")

    cfg = SystemConfig()
    seq = C._room(cfg, C.FPS)
    frames = [seq.frame(i / C.FPS)[:2] for i in range(RGBD_FRAMES)]
    torch.cuda.synchronize()
    _run("rgbd", SlamSystem(cfg, dev), frames,
         lambda s, i, f: s.track_rgbd(*f, i / C.FPS))

    cfg = C.inertial_config()
    seq = C._room(cfg, C.FPS)
    frames = []
    for i in range(INERTIAL_FRAMES):
        g, d, _ = seq.frame(i / C.FPS)
        imu = (None if i == 0 else tuple(
            x.cpu().numpy() for x in seq.imu_between(
                (i - 1) / C.FPS, i / C.FPS,
                cfg.imu.max_samples_per_frame)))
        frames.append((FC.pack_m12_torch(g, d), imu))
    torch.cuda.synchronize()

    def step(s, i, f):
        if f[1] is None:
            return s.track_rgbd(f[0], None, i / C.FPS)
        return s.track_rgbd_inertial(f[0], None, *f[1], i / C.FPS)
    _run("inertial", SlamSystem(cfg, dev, vocab=C._vocabulary()), frames,
         step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
