"""The landmark-sharded global BA at production shapes (the counterpart of
the JAX package's __graft_entry__.dryrun_multichip and
tools/bench_multichip.py).

Builds the production map (256 KFs on a slow lateral sweep, each observing
an overlapping 512-point window of 4096 landmarks, the landmarks offset by
2 cm; k_max 256, m_max 16384; at 4096 landmarks the JAX dry run's own
landmark draw, `reference_landmarks()`; numpy's draw at any other
`--pts`), then runs local_mapping's global_ba_step_distributed at ba_pts
4096 over a LandMesh. Gates: finite poses and points, and the median
landmark error after 2 iterations under 2 cm (the JAX dry run's gate);
at production shapes also within 5e-5 m of the JAX dry run's own reading
(REFERENCE_MEDIAN_ERR). Then, per mesh size, the ms per iteration of
the sharded step (CUDA events around `--reps` calls of one iteration,
after one warm-up call), the bytes summed on the reducing device per
iteration, and the KF translations after 5 iterations against the first
mesh size's (tools/bench_multichip.py's agreement column).

    python3 geoflowslam_tpu_torch/tools/dryrun_multichip.py \
        [--meshes 1,4] [--reps 5] [--devices cuda:0] [--device cuda|cpu] \
        [--kfs 256 --obs 512 --pts 4096 --m-max 16384]

`--devices` lists the card(s) the shards go to, in turn: `--meshes 4` on
one card puts four shards on it. The device is CUDA unless --device cpu is
given; a CUDA device without CUDA raises.
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

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from geoflowslam_tpu_torch.config import MappingConfig  # noqa: E402
from geoflowslam_tpu_torch.parallel import dist_ba  # noqa: E402
from geoflowslam_tpu_torch.pipeline import local_mapping as LM  # noqa
from geoflowslam_tpu_torch.state import map_state as M  # noqa: E402


LANDMARKS_PATH = (Path(__file__).resolve().parents[1] / "assets"
                  / "dryrun_landmarks.npy")


def reference_landmarks() -> np.ndarray:
    """The JAX dry run's 4096 landmarks ([4096, 3] float32: its
    jax.random.uniform(PRNGKey(0)) draw in [-6, 6] x [-3, 3] x [4, 10],
    stored as the port's asset; tests/test_torch_parallel.py holds it
    equal to the draw)."""
    return np.load(LANDMARKS_PATH)


def populated_map(device, k_used=256, n_kp=512, n_pts=4096, m_max=16384,
                  k_max=256, pts=None, desc=None):
    """A production-scale MapState: `k_used` KFs on a slow lateral sweep,
    each observing an overlapping `n_kp`-point window of `n_pts` landmarks
    (pixels projected exactly at fx 400, cx 320, cy 240), the landmarks
    stored 2 cm off. `pts` [n_pts, 3] and `desc` [n_pts, 8] default to draws
    of numpy's RandomState(0) from the same ranges (the JAX dry run's
    own landmarks: `reference_landmarks()`). Returns (ms, true landmark
    positions)."""
    dev = torch.device(device)
    rng = np.random.RandomState(0)
    if pts is None:
        pts = rng.uniform([-6, -3, 4.0], [6, 3, 10.0], (n_pts, 3))
    if desc is None:
        desc = rng.randint(0, 2 ** 31 - 1, (n_pts, 8))
    pts = torch.as_tensor(np.array(pts, np.float32), device=dev)
    desc = torch.as_tensor(np.asarray(desc).astype(np.int64)
                           .astype(np.int32), device=dev)
    ms = M.create(k_max, n_kp, m_max, dev)
    stride = max(1, (n_pts - n_kp) // max(k_used - 1, 1))
    eye = torch.eye(3, device=dev)
    cxy = torch.tensor([320.0, 240.0], device=dev)
    for i in range(k_used):
        obs = (i * stride + torch.arange(n_kp, device=dev)) % n_pts
        t = torch.tensor([-0.02 * i, 0.005 * i, 0.0], device=dev)
        pc = pts[obs] + t
        uv = pc[:, :2] / pc[:, 2:3] * 400.0 + cxy
        ms = M.insert_keyframe(
            ms, i, eye, t, 0.5 * i, uv,
            torch.zeros(n_kp, dtype=torch.int32, device=dev),
            torch.zeros(n_kp, device=dev), desc[obs],
            torch.full((n_kp,), -1.0, device=dev),
            torch.ones(n_kp, dtype=torch.bool, device=dev),
            obs.to(torch.int32), i - 1)
    ms = M.add_map_points(
        ms, torch.arange(n_pts, device=dev), pts + 0.02, desc,
        torch.zeros((n_pts, 3), device=dev), torch.zeros(n_pts, device=dev),
        torch.full((n_pts,), 100.0, device=dev), 0,
        torch.ones(n_pts, dtype=torch.bool, device=dev))
    return ms, pts


def mesh_of(n: int, devices) -> dist_ba.LandMesh:
    """n shards over `devices` in turn."""
    return dist_ba.LandMesh([devices[i % len(devices)] for i in range(n)])


# The JAX dry run's median landmark error after 2 iterations on its own
# landmark draw at production shapes (__graft_entry__'s map, ba_pts 4096),
# read on the CPU: 0.019927725 m on 4 virtual devices, 0.019927613 m on 1.
REFERENCE_MEDIAN_ERR = 0.019927725
# The port parts from it by float32 summation order alone: 6.1e-6 m on an
# H100, 1.5e-5 m on the CPU (4 shards each).
REFERENCE_ERR_TOL = 5e-5


def check_gate(ms, pts, mesh, ba_pts=4096, iters=2,
               reference=None) -> float:
    """global_ba_step_distributed's gate: finite state and the median
    landmark error after `iters` iterations under 2 cm, and within
    REFERENCE_ERR_TOL of `reference` (m) when one is given. Returns it
    (m)."""
    out = LM.global_ba_step_distributed(ms, MappingConfig(), mesh,
                                        ba_pts=ba_pts, iters=iters)
    assert bool(torch.isfinite(out.kf_t).all()), "non-finite KF poses"
    assert bool(torch.isfinite(out.mp_pos).all()), "non-finite points"
    err = float(torch.linalg.norm(out.mp_pos[:pts.shape[0]] - pts,
                                  dim=1).median())
    assert err < 0.02, f"median landmark error {err} m after {iters} iters"
    assert reference is None or abs(err - reference) < REFERENCE_ERR_TOL, (
        f"median landmark error {err} m, the JAX dry run's {reference} m")
    return err


def time_iteration(prob, mesh, reps: int = 5) -> float:
    """ms per sharded GN iteration (shard, step, gather), CUDA events around
    `reps` calls after one warm-up; host wall time on the CPU."""
    c = MappingConfig()
    fn = dist_ba.make_distributed_ba(mesh, c.fx, c.fy, c.cx, c.cy, c.bf,
                                     iters=1)
    fn(prob)
    cuda = prob.pts.is_cuda
    if cuda:
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
    else:
        w0 = time.perf_counter()
    for _ in range(reps):
        fn(prob)
    if cuda:
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps
    return (time.perf_counter() - w0) * 1e3 / reps


def gba_problem(ms, ba_pts=4096):
    """The global BA's extracted problem (the timing's input)."""
    in_win, fixed = LM._gba_window(ms)
    return LM._gba_extract(ms, in_win, fixed, MappingConfig(), ba_pts)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1,4")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None,
                    help="comma-separated shard devices (default: --device)")
    ap.add_argument("--kfs", type=int, default=256)
    ap.add_argument("--obs", type=int, default=512)
    ap.add_argument("--pts", type=int, default=4096)
    ap.add_argument("--m-max", type=int, default=16384)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    devices = (args.devices.split(",") if args.devices else [str(dev)])
    t0 = time.time()
    ref = reference_landmarks()
    ms, pts = populated_map(dev, k_used=args.kfs, n_kp=args.obs,
                            n_pts=args.pts, m_max=args.m_max,
                            k_max=args.kfs,
                            pts=ref if args.pts == len(ref) else None)
    sizes = [int(x) for x in args.meshes.split(",")]
    production = (args.kfs, args.obs, args.pts, args.m_max) == (
        256, 512, len(ref), 16384)
    err = check_gate(ms, pts, mesh_of(max(sizes), devices), args.pts,
                     reference=REFERENCE_MEDIAN_ERR if production else None)
    prob = gba_problem(ms, args.pts)
    c = MappingConfig()
    rows, first = [], None
    for n in sizes:
        mesh = mesh_of(n, devices)
        kf_t = dist_ba.make_distributed_ba(mesh, c.fx, c.fy, c.cx, c.cy,
                                           c.bf, iters=5)(prob).kf_t
        first = kf_t if first is None else first
        rows.append(dict(
            mesh=n, devices=[str(d) for d in mesh.devices],
            ms_per_iter=time_iteration(prob, mesh, args.reps),
            reduced_bytes_per_iter=dist_ba.reduced_bytes(args.kfs, mesh),
            kf_t_vs_first_after_5=float((kf_t - first).abs().max())))
        print(f"mesh {n}: {rows[-1]['ms_per_iter']:.3f} ms/iter, "
              f"{rows[-1]['reduced_bytes_per_iter']} B reduced/iter, KF "
              f"translations after 5 iterations within "
              f"{rows[-1]['kf_t_vs_first_after_5']:.3e} m of mesh "
              f"{sizes[0]}'s")
    out = dict(kfs=args.kfs, pts=args.pts, median_err_m_after_2=err,
               rows=rows, seconds=time.time() - t0)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
