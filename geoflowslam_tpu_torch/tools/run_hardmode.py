"""Hard-mode run of the port: the long synthetic sequence of
geoflowslam_tpu_torch.io.synthetic.HardSyntheticSequence (loop revisits
every 40 s, fast-rotation bursts, texture-poor windows) through
SlamSystem.track_rgbd (--mode rgbd) or track_rgbd_inertial with the
sequence's 200 Hz IMU samples (--mode rgbd_inertial, ImuConfig()) on the
packed m12 feed, with the configuration of the JAX package's hard-mode
script (examples/run_hardmode.py).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 geoflowslam_tpu_torch/tools/run_hardmode.py --mode rgbd \
        [--frames 2000] [--out results_hard_torch/rgbd] [--loop] \
        [--of] [--icp] [--lidar] [--reference results_hard/rgbd]

The sequence is rendered on the device in batches, packed there
(io/feed_codec.pack_m12_torch) and kept in host memory with the IMU
samples of every frame gap (HardSyntheticSequence.imu_between); only the
track call is timed, with a device sync after each frame. Writes to --out:
  hardmode.json       ATE/RPE against the analytic ground truth, the map,
                      per-KF mapping cost (the New_KF stage timer, early and
                      late halves), KF-frame wall time, loops, merges,
                      kf_stall_warnings, n_lost, n_recovered (frames
                      the recovery step took), n_reloc (of those, the
                      relocalized ones), ms a frame; with the IMU also
                      imu_modes (frames per imu_mode), vi_accepted,
                      imu_init_time_s (since the first frame),
                      viba1_done and viba2_done; with --lidar
                      global_map_points;
  frames_diag.jsonl   [frame, seconds, state, n_lost] per frame;
  inliers_diag.jsonl  [t, motion-model inliers, local-map inliers] per frame;
  CameraTrajectory.txt  the exported trajectory, TUM format (t tx ty tz qx
                      qy qz qw), as the JAX script's shutdown writes it.
Both diagnostics are rewritten every 100 frames, so a run cut short leaves
how far it got. --reference DIR prints the accuracy and map numbers of a
hardmode.json of the JAX package beside this run's, with the frames where
either side is not OK, the first frame where the states differ, the first
frame where the local-map inlier counts part by more than 30%, each
side's frames under min_inliers_ok local-map inliers, the port's
frames that were OK all the same (taken by the recovery step, or
ICP-carried), and the two exported trajectories' distance per frame.
--report-only
compares an existing --out with --reference without running.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from geoflowslam_tpu_torch.config import (FrameConfig, ImuConfig,  # noqa
                                          LoopConfig, OrbConfig, SystemConfig)
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe  # noqa: E402
from geoflowslam_tpu_torch.io import feed_codec as FC  # noqa: E402
from geoflowslam_tpu_torch.io.synthetic import (  # noqa: E402
    Camera, HardSyntheticSequence, SyntheticWorld, contrast_schedule,
    hard_trajectory)
from geoflowslam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from geoflowslam_tpu_torch.retrieval.vocab import \
    default_vocabulary  # noqa: E402

FLUSH_EVERY = 100
MIN_OK = SystemConfig().min_inliers_ok


def make_config(width: int, height: int, features: int, loop: bool,
                of: bool, icp: bool, imu: bool = False,
                lidar: bool = False) -> SystemConfig:
    """The JAX hard-mode script's RGB-D (with `imu`: RGB-D-inertial)
    configuration."""
    fx = width * 0.625
    orb = OrbConfig(n_features=features, n_levels=8 if width >= 640 else 4,
                    height=height, width=width)
    fc = FrameConfig(orb=orb, bf=fx * 0.1, lk_levels=4, cloud_stride=4,
                     cloud_max_pts=4096, depth_map_factor=1.0,
                     n_of_slots=256 if of else 0, feed_codec="m12")
    return SystemConfig(fx=fx, fy=fx, cx=width / 2, cy=height / 2,
                        bf=fx * 0.1, frame=fc,
                        loop=LoopConfig() if loop else None,
                        imu=ImuConfig() if imu else None,
                        use_of=of, use_icp=icp, use_lidar=lidar, k_max=128,
                        m_max=32768)


def ground_truth(seq: HardSyntheticSequence, ts: np.ndarray):
    """(Tcw rotations [N, 3, 3], translations [N, 3], Twc [N, 4, 4]) at
    times ts, float32 on the host."""
    rot_wc, p, *_ = hard_trajectory(
        torch.as_tensor(ts, dtype=torch.float32, device=seq.world.device),
        seq.period)
    rot_wc, p = rot_wc.cpu().numpy(), p.cpu().numpy()
    rot_cw = np.swapaxes(rot_wc, -1, -2)
    t_cw = -np.einsum("nij,nj->ni", rot_cw, p)
    twc = np.tile(np.eye(4), (len(ts), 1, 1))
    twc[:, :3, :3] = rot_wc
    twc[:, :3, 3] = p
    return rot_cw, t_cw, twc


@torch.no_grad()
def prerender(seq: HardSyntheticSequence, rot_cw, t_cw, ts,
              batch: int = 32) -> list:
    """m12 buffers of every frame: rendered and packed on the world's
    device, copied to the host once per `batch` frames."""
    dev = seq.world.device
    out = []
    for i in range(0, len(ts), batch):
        bufs = []
        for j in range(i, min(i + batch, len(ts))):
            g, d = seq.world.render(torch.from_numpy(rot_cw[j]).to(dev),
                                    torch.from_numpy(t_cw[j]).to(dev))
            c = contrast_schedule(ts[j], seq.period)
            bufs.append(FC.pack_m12_torch(110.0 + (g - 110.0) * c, d))
        out.extend(torch.stack(bufs).cpu().numpy())
    return out


def _halves(v):
    """(mean of the first half without its first entry, mean of the second
    half), or NaNs under 8 entries."""
    if len(v) < 8:
        return float("nan"), float("nan")
    half = len(v) // 2
    return float(np.mean(v[1:half])), float(np.mean(v[half:]))


def _quat_xyzw(r: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w), w >= 0, of a rotation matrix."""
    m = np.asarray(r, np.float64)
    k = np.array([
        [m[0, 0] - m[1, 1] - m[2, 2], 0.0, 0.0, 0.0],
        [m[0, 1] + m[1, 0], m[1, 1] - m[0, 0] - m[2, 2], 0.0, 0.0],
        [m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], m[2, 2] - m[0, 0] - m[1, 1],
         0.0],
        [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1],
         m[0, 0] + m[1, 1] + m[2, 2]]]) / 3.0
    w, v = np.linalg.eigh(k)
    q = v[:, np.argmax(w)]
    return q if q[3] >= 0 else -q


def write_tum(path: str, traj) -> None:
    """[(t, Twc 4x4)] as TUM lines: t tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for t, m in traj:
            q = _quat_xyzw(m[:3, :3])
            f.write(f"{t:.6f} " + " ".join(f"{x:.7f}" for x in (
                *m[:3, 3], *q)) + "\n")


def read_tum(path: str) -> dict:
    """TUM lines -> {round(t, 4): position [3]}."""
    rows = np.loadtxt(path, ndmin=2)
    return {round(float(r[0]), 4): r[1:4] for r in rows}


def _write_diag(out_dir: str, diag: list, inliers: list) -> None:
    for name, rows in (("frames_diag.jsonl", diag),
                       ("inliers_diag.jsonl", inliers)):
        path = os.path.join(out_dir, name)
        with open(path + ".tmp", "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        os.replace(path + ".tmp", path)


def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "not read"


def run(args) -> dict:
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        from geoflowslam_tpu_torch import kernels
        t0 = time.perf_counter()
        kernels.load()
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    w, h = args.width, args.height
    inertial = args.mode == "rgbd_inertial"
    cfg = make_config(w, h, args.features, args.loop, args.of, args.icp,
                      imu=inertial, lidar=args.lidar)
    cam = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=w,
                 height=h)
    seq = HardSyntheticSequence(SyntheticWorld(cam, device=dev),
                                fps=args.fps)
    ts_all = np.arange(args.frames) / args.fps
    rot_cw, t_cw, twc_gt = ground_truth(seq, ts_all)
    t0 = time.perf_counter()
    bufs = prerender(seq, rot_cw, t_cw, ts_all)
    print(f"pre-rendered {args.frames} m12 frames {w}x{h} in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    imu = [None] + [tuple(x.cpu().numpy() for x in seq.imu_between(
        ts_all[i - 1], ts_all[i], cfg.imu.max_samples_per_frame))
        for i in range(1, args.frames)] if inertial else None

    slam = SlamSystem(cfg, dev, vocab=default_vocabulary(dev))
    os.makedirs(args.out, exist_ok=True)
    gt, diag, kf_wall, ms_frame = [], [], [], []
    ref_before, prev_state = -1, None
    t_start = time.perf_counter()
    for i in range(args.frames):
        t_abs = args.t0 + ts_all[i]
        tk0 = time.perf_counter()
        if inertial and i > 0:
            slam.track_rgbd_inertial(bufs[i], None, *imu[i], t_abs)
        else:
            slam.track_rgbd(bufs[i], None, t_abs)
        if cuda:
            torch.cuda.synchronize()
        tk = time.perf_counter() - tk0
        ms_frame.append(tk * 1000.0)
        if slam.ref_kf != ref_before:
            ref_before = slam.ref_kf
            if i > 0:
                kf_wall.append(tk * 1000.0)
        st = slam.state.name
        diag.append((i, round(tk, 4), st, slam.n_lost))
        if st != prev_state:
            print(f"  [diag] frame {i} (t={ts_all[i]:.2f}s): state -> {st} "
                  f"(n_lost={slam.n_lost}, {tk * 1000:.0f} ms)",
                  file=sys.stderr)
            prev_state = st
        gt.append((t_abs, twc_gt[i]))
        if (i + 1) % FLUSH_EVERY == 0:
            _write_diag(args.out, diag, slam.inlier_log)
            recent = ms_frame[-FLUSH_EVERY:]
            print(f"frame {i}: {slam.map_stats()}; last {len(recent)}: "
                  f"median {np.median(recent):.0f} ms, max "
                  f"{np.max(recent):.0f} ms; n_lost={slam.n_lost}, "
                  f"n_recovered={slam.n_recovered}, "
                  f"n_reloc={slam.n_reloc}", file=sys.stderr)
    wall = time.perf_counter() - t_start
    _write_diag(args.out, diag, slam.inlier_log)

    st = slam.map_stats()
    traj = slam.trajectory
    write_tum(os.path.join(args.out, "CameraTrajectory.txt"), traj)
    m = ate_rmse(traj, gt)
    r = rpe(traj, gt)
    early, late = _halves(slam.timers.samples.get("New_KF", []))
    wall_early, wall_late = _halves(kf_wall)
    lc = slam.loop_closer
    steady = np.asarray(ms_frame[1:])
    out = {"mode": args.mode, "frames": args.frames, "of": args.of,
           "icp": args.icp, "lidar": args.lidar, "loop": args.loop,
           "ate_rmse_m": m["ate_rmse"], "rpe_trans_m": r["rpe_trans"],
           "rpe_rot_deg": r["rpe_rot_deg"], "map": st,
           "kf_cost_early_ms": early, "kf_cost_late_ms": late,
           "kf_wall_early_ms": wall_early, "kf_wall_late_ms": wall_late,
           "loops": lc.n_loops if lc else 0,
           "merges": lc.n_merges if lc else 0,
           "kf_stall_warnings": slam.kf_stall_warnings,
           "n_lost": slam.n_lost, "n_recovered": slam.n_recovered,
           "n_reloc": slam.n_reloc,
           "fps": args.frames / wall,
           "ms_per_frame_median": float(np.median(steady)),
           "ms_per_frame_p90": float(np.percentile(steady, 90)),
           "device": (torch.cuda.get_device_name(dev) if cuda
                      else "cpu"),
           "card": _card() if cuda else "cpu"}
    if args.lidar:
        out.update(global_map_points=len(slam.global_map.points()))
    if inertial:
        out.update(imu_modes=slam.imu_modes, vi_accepted=slam.n_vi_accepted,
                   imu_init_time_s=slam.imu.init_time,
                   viba1_done=slam.imu.viba1_done,
                   viba2_done=slam.imu.viba2_done)
    with open(os.path.join(args.out, "hardmode.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"{args.frames} frames in {wall:.1f} s; map {st}; ATE "
          f"{m['ate_rmse'] * 100:.2f} cm, RPE {r['rpe_trans'] * 100:.2f} cm /"
          f" {r['rpe_rot_deg']:.3f} deg; n_lost {slam.n_lost}, n_recovered "
          f"{slam.n_recovered}, n_reloc {slam.n_reloc}, kf_stall_warnings {slam.kf_stall_warnings}; "
          f"New_KF early {early:.1f} ms, late {late:.1f} ms; ms/frame median "
          f"{out['ms_per_frame_median']:.1f}, p90 "
          f"{out['ms_per_frame_p90']:.1f}; card {out['card']}")
    return out


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def compare(port_dir: str, ref_dir: str, t0: float, fps: float) -> dict:
    """Print a JAX hardmode.json beside this run's and where the two runs
    part (frames of stamps t0 + i / fps); returns what it printed."""
    # accuracy and map numbers only: the reference's times are another
    # device's and no yardstick for these
    keys = ("ate_rmse_m", "rpe_trans_m", "rpe_rot_deg", "kf_stall_warnings",
            "n_lost", "n_recovered", "n_reloc")
    runs = {}
    for tag, d in (("port", port_dir), ("reference", ref_dir)):
        path = os.path.join(d, "hardmode.json")
        runs[tag] = json.load(open(path)) if os.path.exists(path) else {}
    for k in keys + ("map",):
        print(f"  {k:20s} port {runs['port'].get(k)!s:40s} reference "
              f"{runs['reference'].get(k)}")
    fp = _read_jsonl(os.path.join(port_dir, "frames_diag.jsonl"))
    fr = _read_jsonl(os.path.join(ref_dir, "frames_diag.jsonl"))
    n = min(len(fp), len(fr))
    not_ok = {"port": [r[0] for r in fp if r[2] != "OK"],
              "reference": [r[0] for r in fr if r[2] != "OK"]}
    first_state = next((i for i in range(n) if fp[i][2] != fr[i][2]), None)
    ip = {round(r[0], 4): r for r in _read_jsonl(
        os.path.join(port_dir, "inliers_diag.jsonl"))}
    ir = {round(r[0], 4): r for r in _read_jsonl(
        os.path.join(ref_dir, "inliers_diag.jsonl"))}
    common = sorted(set(ip) & set(ir))
    frame = lambda t: int(round((t - t0) * fps))           # noqa: E731
    first_inl = None
    for t in common:
        a, b = ip[t][2], ir[t][2]
        if abs(a - b) > 0.3 * max(a, b, 1):
            first_inl = (frame(t), a, b)
            break
    # the reference's recorded state can trail its frames by a read batch
    # (its decision ring); its inlier log is per frame
    failed = {tag: [frame(t) for t in common if log[t][2] < MIN_OK]
              for tag, log in (("port", ip), ("reference", ir))}
    # the port's state is its frame's own: OK under MIN_OK local-map
    # inliers means the recovery step took the frame, or ICP carried it
    ok_failed = [i for i in failed["port"]
                 if i < len(fp) and fp[i][2] == "OK"]
    print(f"  frames compared: {n} (port {len(fp)}, reference {len(fr)})")
    for tag in ("port", "reference"):
        print(f"  frames not OK, {tag}: {not_ok[tag]}")
    print(f"  first frame whose states differ: {first_state}")
    print(f"  first frame whose local-map inliers part by > 30% (frame, "
          f"port, reference): {first_inl}")
    for tag in ("port", "reference"):
        print(f"  frames under {MIN_OK} local-map inliers, {tag}: "
              f"{failed[tag]}")
    print(f"  port frames OK under {MIN_OK} local-map inliers (recovery "
          f"step or ICP-carried): {ok_failed}")
    dist = None
    paths = [os.path.join(d, "CameraTrajectory.txt")
             for d in (port_dir, ref_dir)]
    if all(os.path.exists(x) for x in paths):
        tp, tr = read_tum(paths[0]), read_tum(paths[1])
        both = sorted(set(tp) & set(tr))
        d = np.array([np.linalg.norm(tp[t] - tr[t]) for t in both])
        part = next((frame(t) for t, x in zip(both, d) if x > 0.02), None)
        dist = dict(n=len(both), max_m=float(d.max()) if len(d) else None,
                    median_m=float(np.median(d)) if len(d) else None,
                    first_frame_over_2cm=part)
        print(f"  exported poses of both ({len(both)} frames): distance "
              f"median {dist['median_m']}, max {dist['max_m']} m; first "
              f"frame over 2 cm: {part}")
    return dict(runs=runs, not_ok=not_ok, first_state_diff=first_state,
                first_inlier_diff=first_inl, failed=failed,
                ok_failed=ok_failed, pose_distance=dist)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="rgbd",
                    choices=["rgbd", "rgbd_inertial", "mono"])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--t0", type=float, default=1.4e9)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--out", default="results_hard_torch/rgbd")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--of", action="store_true")
    ap.add_argument("--icp", action="store_true")
    ap.add_argument("--lidar", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default=None)
    ap.add_argument("--report-only", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "mono":
        raise NotImplementedError(f"not ported yet: --mode {args.mode}")
    if not args.report_only:
        run(args)
    if args.reference:
        print(f"beside the reference {args.reference}:")
        compare(args.out, args.reference, args.t0, args.fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
