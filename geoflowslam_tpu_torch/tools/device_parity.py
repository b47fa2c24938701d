"""Where a card run of the port parts from a CPU run on the same input bytes.

The hard sequence's first frames (tools/run_hardmode.py's configuration,
640x480, 1000 features) are rendered and packed on the CPU once; the card
and the CPU then take the same buffers. For each of the first --frames
frames, stage by stage of the front end as state/frame.build_frame runs
it: the unpacked gray image, its CLAHE (ops/pyramid.clahe, with
FrameConfig.use_clahe), each pyramid level (ops/pyramid.build_pyramid:
max |card - CPU| and the pixels that differ), the two FAST score maps of
each level (ops/fast.fast_nms_levels: the pixels that differ), and the
extracted keypoints (ops/extractor.extract: the slots whose validity,
position, level or descriptor differ, the largest angle difference). Then two SlamSystems,
one on each device, track those frames as run_hardmode --mode
rgbd_inertial does: each frame's (motion-model, local-map) inlier counts
and the distance between the two returned positions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 geoflowslam_tpu_torch/tools/device_parity.py [--frames 6] \\
        [--width 640 --height 480 --features 1000] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from geoflowslam_tpu_torch.io import feed_codec as FC  # noqa: E402
from geoflowslam_tpu_torch.io.synthetic import (  # noqa: E402
    Camera, HardSyntheticSequence, SyntheticWorld)
from geoflowslam_tpu_torch.ops import fast as fast_ops  # noqa: E402
from geoflowslam_tpu_torch.ops import pyramid as pyr_ops  # noqa: E402
from geoflowslam_tpu_torch.ops.extractor import extract  # noqa: E402
from geoflowslam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from geoflowslam_tpu_torch.retrieval.vocab import \
    default_vocabulary  # noqa: E402
from geoflowslam_tpu_torch.tools import run_hardmode as RH  # noqa: E402

CPU = torch.device("cpu")


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    """max |a - b| and the count of differing elements (a on any device)."""
    a = a.cpu()
    d = (a.double() - b.double()).abs()
    return {"max_abs": float(d.max()), "n_differ": int((a != b).sum())}


def front_end(buf: np.ndarray, cfg, dev) -> dict:
    """Each front-end stage of one m12 buffer on `dev` and on the CPU."""
    h, w, orb = cfg.frame.orb.height, cfg.frame.orb.width, cfg.frame.orb
    out = {}
    grays = [FC.unpack_m12_torch(torch.from_numpy(buf).to(d), h, w,
                                 cfg.frame.depth_map_factor)[0]
             for d in (dev, CPU)]
    out["gray"] = _diff(*grays)
    if cfg.frame.use_clahe:
        grays = [pyr_ops.clahe(g) for g in grays]
        out["clahe"] = _diff(*grays)
    lv = [pyr_ops.build_pyramid(g, orb.n_levels, orb.scale_factor)
          for g in grays]
    out["levels"] = [_diff(a, b) for a, b in zip(*lv)]
    maps = [fast_ops.fast_nms_levels(x, orb.min_th_fast, orb.ini_th_fast)
            for x in lv]
    out["fast_maps"] = [[_diff(a, b)["n_differ"] for a, b in zip(ma, mb)]
                        for ma, mb in zip(*maps)]
    fs = [extract(g, orb) for g in grays]
    a, b = fs[0]._replace(**{k: v.cpu() for k, v in
                             fs[0]._asdict().items()}), fs[1]
    both = a.valid & b.valid
    out["keypoints"] = {
        "valid": [int(a.valid.sum()), int(b.valid.sum())],
        "validity_differs": int((a.valid != b.valid).sum()),
        "uv_differs": int((both & (a.uv != b.uv).any(-1)).sum()),
        "level_differs": int((both & (a.level != b.level)).sum()),
        "desc_differs": int((both & (a.desc != b.desc).any(-1)).sum()),
        "angle_max_abs": float((a.angle - b.angle)[both].abs().max())
        if bool(both.any()) else 0.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--t0", type=float, default=1.4e9)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from geoflowslam_tpu_torch import kernels
        kernels.load()
    w, h = args.width, args.height
    cfg = RH.make_config(w, h, args.features, False, False, False, imu=True)
    cam = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=w,
                 height=h)
    seq = HardSyntheticSequence(SyntheticWorld(cam, device=CPU),
                                fps=args.fps)
    ts = np.arange(args.frames) / args.fps
    rot_cw, t_cw, _ = RH.ground_truth(seq, ts)
    bufs = RH.prerender(seq, rot_cw, t_cw, ts)
    imu = [None] + [tuple(x.cpu().numpy() for x in seq.imu_between(
        ts[i - 1], ts[i], cfg.imu.max_samples_per_frame))
        for i in range(1, args.frames)]
    report = {"frames": []}
    with torch.no_grad():
        for i, buf in enumerate(bufs):
            fe = front_end(buf, cfg, dev)
            report["frames"].append({"frame": i, "front_end": fe})
            print(f"frame {i}: gray {fe['gray']}; clahe {fe.get('clahe')}; "
                  f"pyramid max |card - CPU| "
                  f"{[x['max_abs'] for x in fe['levels']]}, pixels "
                  f"differing {[x['n_differ'] for x in fe['levels']]}; "
                  f"FAST map pixels differing (low, high) "
                  f"{fe['fast_maps']}; keypoints {fe['keypoints']}",
                  flush=True)
    systems = [SlamSystem(cfg, d, vocab=default_vocabulary(d))
               for d in (dev, CPU)]
    for i, buf in enumerate(bufs):
        pos = []
        for s in systems:
            t = args.t0 + ts[i]
            twc = (s.track_rgbd(buf, None, t) if i == 0 else
                   s.track_rgbd_inertial(buf, None, *imu[i], t))
            pos.append(np.asarray(torch.as_tensor(twc).cpu())[:3, 3])
        inl = [list(s.inlier_log[-1][1:]) if s.inlier_log else None
               for s in systems]
        gap = float(np.linalg.norm(pos[0] - pos[1]))
        report["frames"][i]["track"] = {"inliers": inl, "gap_m": gap,
                                        "states": [s.state.name
                                                   for s in systems]}
        print(f"frame {i}: inliers (card, CPU) {inl}, position gap "
              f"{gap:.3e} m, states {[s.state.name for s in systems]}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
