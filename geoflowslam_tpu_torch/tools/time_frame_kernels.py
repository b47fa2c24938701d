"""Time the kernels of a frame and of a relocalization attempt on the card:
FAST and the optical-flow stage's Lucas-Kanade, as the per-level
composition and, where the tree has them, as the fused entries, and the two
Hamming searches.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 geoflowslam_tpu_torch/tools/time_frame_kernels.py
    python3 geoflowslam_tpu_torch/tools/time_frame_kernels.py --compare OLD

It imports the package and chip_smoke.py of the current directory, and uses
only entries that exist since the per-level kernels were ported, so the same
file, run from the root of an older checkout, times that checkout. Compare
two trees in one call, on one card, in turns: the host's pace drifts over
time. --compare OLD does so for an older checkout unpacked at OLD (a
directory that .gitignore lists) and this one, in the order old, this,
this, old, each a process of its own under a line "== <root>"; the first
run of each tree builds its kernels.

Jobs, at the shapes of the default SystemConfig's paths:
  build            seconds that kernels.load() took, `compiled` true where it
                   ran nvcc (false where the library was already built);
  fast per level   fast_scores_two, nms3x3 of both maps and the 16 px border
                   mask, on each of the 8 levels of the x1.2 pyramid of a
                   random 480x640 image (8 kernel launches and the small
                   PyTorch operations around them);
  fast fused       ops/fast.fast_nms_levels on the same pyramid;
  lk per level     fb_klt_track twice (3 levels with a guess, 4 without; 1
                   backward level, win 21, 10 iterations, 1256 points) on the
                   4-level LK pyramid of a 480x640 texture (9 launches);
  lk fused         ops/klt.fb_klt_track_streams on the same inputs;
  k2 2048x1000, k2 1256x1256
                   kernels.gated_hamming_search under tracking's gate
                   (radius 7.5, octave window [-1, 1]) on chip_smoke.py's
                   inputs;
  k4 six launches  a relocalization attempt's six searches (three 1000 x
                   1000 candidates, both directions) as six
                   kernels.hamming_best2 calls;
  k4 one launch    the same six as one table through
                   kernels.hamming_best2_many, where the tree has it.
Each job prints one JSON line: `event_ms`, the median of 25 CUDA-event pairs
around the call (the host's Python and launches included). For the FAST and
LK jobs `device_ms` is the device time of all kernels of one call, summed
from torch.profiler's CUDA activity over 10 calls; `hand_ms` and
`hand_launches`, the same for the hand-written kernels alone; `n_kernels`,
device kernels per call. Where the profiler records nothing the four read
null; where it loses some launches' records, `hand_launches` reads less than
`launch_counts` says and the sums are that much too small. The Hamming jobs
take `device_ms` from chip_smoke.device_ms instead (their C entries launch
the kernels `reps` times back to back between event pairs). The first line
is the card's name and power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import _k2_inputs, _k4_inputs, _lk_inputs, cuda_ms, device_ms
from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops import fast as FAST
from geoflowslam_tpu_torch.ops import klt as KLT
from geoflowslam_tpu_torch.ops import matching as MA
from geoflowslam_tpu_torch.ops.pyramid import build_pyramid

PROFILED_CALLS = 10
HAND_KERNELS = ("fast_scores_kernel", "fast_nms_levels_kernel",
                "lk_level_kernel", "lk_pyramid_kernel")
LK = dict(fb_thresh=0.5, fb_levels=1, win=21, iters=10, min_eig=1e-4)


def fast_per_level(levels, border=16):
    out = []
    for img in levels:
        h, w = img.shape
        lo, hi = FAST.fast_scores_two(img, 7.0, 20.0)
        lo, hi = FAST.nms3x3(lo), FAST.nms3x3(hi)
        ys = torch.arange(h, device=img.device)[:, None]
        xs = torch.arange(w, device=img.device)[None, :]
        inb = ((ys >= border) & (ys < h - border)
               & (xs >= border) & (xs < w - border))
        out.append((torch.where(inb, lo, 0.0), torch.where(inb, hi, 0.0)))
    return out


def device_times(fn):
    """(ms of all kernels, ms of the hand-written ones, their launches,
    kernels) per call of fn, or four None if the tracer recorded nothing."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    total = hand = 0.0
    n_all = n_hand = 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:                 # the attribute's name in older torch
            us = getattr(ev, "cuda_time_total", 0.0)
        total += us
        n_all += ev.count
        if any(k in ev.key for k in HAND_KERNELS):
            hand += us
            n_hand += ev.count
    if total <= 0:
        return None, None, None, None
    c = PROFILED_CALLS
    return total / c / 1e3, hand / c / 1e3, n_hand / c, n_all / c


def report(job, fn):
    before = dict(kernels.launch_counts)
    fn()
    torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in kernels.launch_counts.items()
               if v != before[k]}
    dev, hand, n_hand, n_all = device_times(fn)
    print(json.dumps({"job": job, "event_ms": cuda_ms(fn), "device_ms": dev,
                      "hand_ms": hand, "hand_launches": n_hand,
                      "n_kernels": n_all, "launch_counts": counted}),
          flush=True)


def hamming_jobs(dev):
    """(job, launch(reps)) of the K2 and K4 jobs this tree can run."""
    out = []
    for n, m in ((2048, 1000), (1256, 1256)):
        a = _k2_inputs(n, m, seed=n + m)
        args = (a["uv_q"], a["level_q"], a["valid_q"], a["desc_q"],
                a["radius"], a["uv_t"], a["level_t"], a["valid_t"],
                a["desc_t"])
        out.append((f"k2 {n}x{m}",
                    lambda reps=1, args=args: kernels.gated_hamming_search(
                        *args, -1, 1, MA.BIG, reps=reps)))
    cands = [_k4_inputs(1000, 1000, 50 + c, dev) for c in range(3)]
    table = cands + [(t, vt, q, vq) for q, vq, t, vt in cands]
    out.append(("k4 six launches",
                lambda reps=1: [kernels.hamming_best2(*s, MA.BIG, reps=reps)
                                for s in table]))
    if hasattr(kernels, "hamming_best2_many"):
        out.append(("k4 one launch",
                    lambda reps=1: kernels.hamming_best2_many(
                        table, MA.BIG, reps=reps)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_frame_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    args = sys.argv[1:]
    if args[:1] == ["--compare"] and len(args) == 2:
        old = os.path.abspath(args[1])
        for root in (old, os.getcwd(), os.getcwd(), old):
            print(f"== {root}", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__)],
                           cwd=root, check=True)
        return 0
    compiled = not kernels.library_path().exists()
    t0 = time.perf_counter()
    kernels.load()
    print(json.dumps({"job": "build", "s": time.perf_counter() - t0,
                      "compiled": compiled}), flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    img = torch.from_numpy((rs.rand(480, 640) * 255).astype(np.float32)).cuda()
    levels = build_pyramid(img, 8, 1.2)
    report("fast per level", lambda: fast_per_level(levels))
    if hasattr(FAST, "fast_nms_levels"):
        report("fast fused",
               lambda: FAST.fast_nms_levels(levels, 7.0, 20.0, 16))

    prev, nxt, pts, guess = _lk_inputs(480, 640, np.random.RandomState(4), dev)
    pyr_p = KLT.build_lk_pyramid(prev, 4)
    pyr_n = KLT.build_lk_pyramid(nxt, 4)
    report("lk per level", lambda: [
        KLT.fb_klt_track(pyr_p, pyr_n, pts, g, max_levels=lv, **LK)
        for g, lv in ((guess, 3), (None, 4))])
    if hasattr(KLT, "fb_klt_track_streams"):
        report("lk fused", lambda: KLT.fb_klt_track_streams(
            pyr_p, pyr_n, pts, [guess, None], [3, 4], **LK))

    for job, launch in hamming_jobs(dev):
        print(json.dumps({"job": job, "event_ms": cuda_ms(launch),
                          "device_ms": device_ms(launch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
