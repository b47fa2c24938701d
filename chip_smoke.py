"""Chip smoke test of the PyTorch/CUDA port (geoflowslam_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

A phase runs alone through the module, after the build, for example

    python3 -c "import chip_smoke as c; c.phase_build(); \
        c.phase_reloc(c.new_summary(), c._vocabulary())"

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: the card's name, and its name and power limit as nvidia-smi
     reports them;
  2. build: compile the hand-written kernels (kernels/csrc/*.cu) with nvcc;
  3. fast: K1 fast_scores vs its plain PyTorch version on random images at
     every level shape of the 480x640, 8-level, x1.2 pyramid, thresholds 7
     and 20: both maps torch.equal; kernel and plain times (CUDA events,
     median);
  4. hamming: K2 gated_hamming_search vs its plain version at (N, M) =
     (1000, 1000), (2048, 1000), (1256, 1256) and (300, 2600) (more targets
     than a block stages at once), under the three callers' gates (radius
     7.5 with octave window [-1, 1], radius 3 with [-1, 1], radius 8 with
     [0, 8]), ~10% invalid rows, half the targets copying a query
     descriptor: best, second and idx torch.equal; times at (2048, 1000) and
     (1256, 1256); `launch_floor_ms`, K2's device time at N = M = 8 (the
     least of three readings), the least one launch costs by the device_ms
     method;
  5. hamming_best2: K4 vs its plain version at (N, M) = (1000, 1000),
     (777, 1013) and (2048, 1000), forward and with the sides swapped (the
     mutual check), ~25% invalid rows and columns, duplicated descriptors
     (index ties), and a (64, 300) case with no valid target, one search a
     launch; then one launch over relocalization's table (three 1000 x 1000
     candidates, both directions) and over a table of mixed sizes: every
     search's best, second and idx torch.equal; times of the six-search
     launch, and of torch.matmul on the same distances as +-1 bf16
     operands, on the device (200 calls in one CUDA graph, timed as
     device_ms) and with its dispatch (the yardstick for the tensor-core
     product; the port never calls it);
  5b. fast_fused: the fused K1 (fast_nms_levels: both thresholds, NMS and
     the border mask of all 8 levels in one launch) vs its plain version on
     the 8-level x1.2 pyramid of a random 480x640 image and of one with flat
     regions (NMS ties): both maps of every level torch.equal; times at the
     path's shape;
  6. lk: K3 lk_level vs its plain version (ops/klt._track_level) on smooth
     random textures at the four LK level shapes of 480x640, N = 1256
     points (~5% near or past the border, some on a flat patch), guesses
     up to 3 px off, win 21 and 31, 10 iterations: where both say ok the
     tracked points agree within 1e-3 px and err within 1e-4, and ok
     differs on at most 0.5% of the points; kernel and plain times;
  6b. lk_fused: the fused K3 (lk_pyramid: both streams' forward-backward
     coarse-to-fine track in one launch) vs ops/klt.fb_klt_track per stream,
     2 streams x 1256 points, 3 and 4 forward levels, 1 backward, win 21, 10
     iterations, on the 4-level LK pyramid of 480x640: the tolerances of 6,
     with status in place of ok;
  6c. entry points: the per-level kernels' public entries (ops/fast.
     fast_scores_two on 8 levels, ops/klt.klt_track over 4 levels) at full
     width on the card, counted apart from the paths under
     `entry_point_launches` (their `launches` read 0: no path runs them);
  7. rgbd: 150 frames at 30 fps of the synthetic room at 640x480, rendered
     by the port, through SlamSystem.track_rgbd with the default
     SystemConfig (1000 features, 8 levels, k_max 256, m_max 65536): state
     OK, >= 3 keyframes, ATE < 5 cm and RPE < 3 cm against ground truth,
     finite poses, K2 launched by the path and the fused K1 exactly once
     per frame;
  8. of_icp: the same with use_of, use_icp and n_of_slots = 256, 150
     frames at 10 fps, a fresh map: the same gates, optical-flow points
     appended, at least one accepted ICP prediction, K2 launched, the fused
     K1 exactly once per frame and the fused K3 once per frame after the
     first;
  9. reloc: relocalization at full width with the shipped vocabulary (see
     phase_reloc), through the façade's default (fused) recovery: a
     relocalization brings the lost system back to OK without a new map,
     within 10 cm of the first pass, K4 launched; ms per relocalization
     attempt on the path, and exactly one K4 launch per attempt; then the
     noisy view relocalized directly as well, within 10 cm of the first
     pass, and timed;
 10. merge: an Atlas break and merge at full width with LoopConfig() and
     the shipped vocabulary (see phase_merge): OK, a merge or loop, >= 90%
     of the KFs in the active map, K2 launched and exactly one K4 launch
     per loop check and per relocalization attempt; ms of the
     loop-correcting KF frame;
 11. hard: the first HARD_FRAMES frames (20 s at 30 fps) of the hard-mode
     sequence through the configuration of
     geoflowslam_tpu_torch/tools/run_hardmode.py (640x480, 1000 features, 8
     levels, k_max 128, m_max 32768), packed m12 buffers pre-rendered on the
     card, the shipped vocabulary, no loop closing: state OK and 1 map at
     the end, ATE < 5 cm and RPE < 3 cm on the tracked frames, finite
     poses, no KF-stall warning, the fused K1 once per frame, K2 launched,
     K4 exactly once per relocalization attempt; n_lost, n_recovered (frames
     the recovery step took), n_reloc and ms per frame (median, p90).
Each path's launch counts are set to 0 just before it and read just after;
every path launches the fused K1 once per frame and the per-level K1 and K3
never. Every kernel has three times: `ms`, the CUDA-event median around its
Python launcher; `device_ms`, the kernel alone (its C entry launches it 200
and 400 times back to back between one event pair each, and the difference
over 200 is one launch; see device_ms); `plain_ms`; and `bound_ms`, the
least time the card could take, the larger of its bytes over 3.35 TB/s and
its operations over 67 TFLOP/s (K4's distance product: over the tensor
cores' 1,979 TOP/s), worked out from this run's inputs. No
PyTorch call computes any of these functions, so `library_ms` is null. The
line before the last is a JSON summary of the kernels (`launches` summed
over the five paths and nothing else) with `launch_floor_ms` beside it; the
last line is {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import torch.nn.functional as F

from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.config import LoopConfig, SystemConfig
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe
from geoflowslam_tpu_torch.io.synthetic import (Camera, HardSyntheticSequence,
                                                SyntheticSequence,
                                                SyntheticWorld)
from geoflowslam_tpu_torch.ops import fast as FAST
from geoflowslam_tpu_torch.ops import klt as KLT
from geoflowslam_tpu_torch.ops import matching as MA
from geoflowslam_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from geoflowslam_tpu_torch.pipeline import reloc as R
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.retrieval import vocab as V
from geoflowslam_tpu_torch.state.frame import build_frame
from geoflowslam_tpu_torch.tools import run_hardmode as HM

KERNEL_INFO = {
    "fast_scores": dict(
        source="geoflowslam_tpu_torch/kernels/csrc/fast_scores.cu",
        replaces="geoflowslam_tpu/ops/pallas_kernels.py:104"),
    "fast_nms_levels": dict(
        source="geoflowslam_tpu_torch/kernels/csrc/fast_scores.cu",
        replaces="geoflowslam_tpu/ops/pallas_kernels.py:104"),
    "gated_hamming_search": dict(
        source="geoflowslam_tpu_torch/kernels/csrc/gated_hamming.cu",
        replaces="geoflowslam_tpu/ops/pallas_kernels.py:300"),
    "lk_level": dict(
        source="geoflowslam_tpu_torch/kernels/csrc/lk_level.cu",
        replaces="geoflowslam_tpu/ops/pallas_kernels.py:461"),
    "lk_pyramid": dict(
        source="geoflowslam_tpu_torch/kernels/csrc/lk_level.cu",
        replaces="geoflowslam_tpu/ops/pallas_kernels.py:461"),
    "hamming_best2": dict(
        source="geoflowslam_tpu_torch/kernels/csrc/hamming_best2.cu",
        replaces="geoflowslam_tpu/ops/pallas_kernels.py:186"),
}
N_FRAMES = 150
FPS = 30.0
OF_FPS = 10.0
RECOVER_FPS = 10.0   # the reloc and merge paths, as their JAX tests stage them
HARD_FRAMES = 600    # the hard path: 20 s, into the first texture-poor window
LK_N = 1256          # n_features + n_of_slots of the OF/ICP path
# K3 vs plain on the card. Samples, template and gradients are equal bit for
# bit (same float32 operations); only the 441- or 961-term sums run in
# another order, which 10 GN steps amplify on ill-conditioned points, and
# the ok gate (min-eigenvalue and in-image tests) can flip on its edge. The
# first run on an H100 read at most 3.8e-6 px and 1.5e-5 in err, with no ok
# flipped, so the bounds sit 250x and 6x above that.
LK_TOL_PX = 1e-3     # tracked points where both versions say ok
LK_TOL_OK = 0.005    # share of points whose ok differs
LK_TOL_ERR = 1e-4    # mean |residual| where both say ok
# The fused K3 is held to the same bounds over its 3 + 1 and 4 + 1 levels
# (the x2 between levels doubles a coarse level's difference, the next
# level's Gauss-Newton steps contract it again), with status, which adds the
# forward-backward gate's edge, in place of ok.

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, float32 rate outside the tensor cores (integer work there is
# reckoned at the same rate), and the tensor cores' dense int8 rate (the
# sheet gives none for 1-bit operands).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12
DEVICE_REPS = 200    # back-to-back launches timed for device_ms
# Operations per pixel of FAST at two thresholds: 16 ring terms of 17 (the
# difference, four compares, and per threshold and side a subtract, a max
# and an add), four arc tests of 11, six to combine; of the NMS and border
# mask for both maps: 2 x (8 max, a compare, a select) + 2.
FAST_OPS_PX = 16 * 17 + 4 * 11 + 6
NMS_OPS_PX = 2 * 10 + 2


def bound_ms(n_bytes: float, n_ops: float, n_tensor_ops: float = 0.0):
    """(least ms the card could take, which limit sets it): every input byte
    read once and every output byte written once at the memory rate, against
    the operations on the CUDA cores at the float32 rate and those on the
    tensor cores at the int8 rate (the two units run side by side)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / F32_OPS_PER_S,
                n_tensor_ops / INT8_TENSOR_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lk_point_level_ops(win: int, iters: int) -> int:
    """Float32 operations of one point on one level: the (win+2)^2 template
    (7 a bilinear sample), gradients and structure tensor (10 a sample), a
    Gauss-Newton pass (sample, residual, two products and sums: 12), the
    residual pass (9), and ~40 for the gate and the solves."""
    nw = win * win
    return (win + 2) ** 2 * 7 + nw * 10 + iters * nw * 12 + nw * 9 + 40


def cuda_ms(fn, reps: int = 25) -> float:
    """Median milliseconds of fn() over `reps` runs, timed with CUDA events
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(launch, reps: int = DEVICE_REPS) -> float:
    """Milliseconds of the kernel alone. launch(reps=n) makes the C entry
    launch the kernel n times back to back; the event-pair time of 2 x reps
    launches minus that of reps (medians of 5), over reps, leaves out what
    the host does before the first launch. The gap between two launches
    stays in (a few microseconds at most: a 32x32 FAST reads 0.0044 ms this
    way), so the number is an upper bound of the kernel's duration."""
    launch(reps=3)
    torch.cuda.synchronize()

    def window(n):
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(reps=n)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    return (window(2 * reps) - window(reps)) / reps


def graph_device_ms(fn, reps: int = DEVICE_REPS) -> float:
    """device_ms of a PyTorch call: `reps` calls of fn captured in one CUDA
    graph, replayed once and twice between event pairs, so that the host's
    dispatch stays out of the window as it does for the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return device_ms(lambda reps: [graph.replay()
                                   for _ in range(reps // DEVICE_REPS)], reps)


def _times(summary, name, launch, plain, n_bytes, n_ops, n_tensor_ops=0.0):
    """Time a kernel three ways beside its bound and keep the numbers under
    its launcher's name."""
    ms = cuda_ms(launch)
    dms = device_ms(launch)
    pms = cuda_ms(plain)
    bms, by = bound_ms(n_bytes, n_ops, n_tensor_ops)
    summary[name].update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None)
    return (f"kernel {ms:.4f} ms with its launcher, {dms:.4f} ms on the "
            f"device, plain {pms:.4f} ms, bound {bms:.5f} ms ({by})")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.load()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")


def phase_fast(summary):
    rs = np.random.RandomState(0)
    err = 0.0
    for h, w in pyramid_shapes(480, 640, 8, 1.2):
        img = torch.from_numpy(
            (rs.rand(h, w) * 255).astype(np.float32)).cuda()
        lo_k, hi_k = kernels.fast_scores(img, 7.0, 20.0)
        lo_p, hi_p = FAST.fast_score_maps(img, [7.0, 20.0])
        torch.cuda.synchronize()
        if not (torch.equal(lo_k, lo_p) and torch.equal(hi_k, hi_p)):
            raise AssertionError(f"fast_scores differs from plain at {h}x{w}")
        e = max(float((lo_k - lo_p).abs().max()),
                float((hi_k - hi_p).abs().max()))
        err = max(err, e)
        if (h, w) == (480, 640):
            t = _times(summary, "fast_scores",
                       lambda reps=1: kernels.fast_scores(img, 7.0, 20.0,
                                                          reps=reps),
                       lambda: FAST.fast_score_maps(img, [7.0, 20.0]),
                       12 * h * w, FAST_OPS_PX * h * w)
        else:
            ms = cuda_ms(lambda: kernels.fast_scores(img, 7.0, 20.0))
            t = f"kernel {ms:.4f} ms with its launcher"
        print(f"[K1] fast_scores {h}x{w}: equal, max_abs_err {e}, {t}")
    summary["fast_scores"]["max_abs_err"] = err


def _flat_image(rs, h, w):
    """Random 12 px blocks: corners between flat regions, where equal scores
    meet in the non-maximum suppression."""
    big = np.kron(rs.randint(0, 6, (h // 12 + 1, w // 12 + 1)) * 50.0,
                  np.ones((12, 12)))
    return torch.from_numpy(big[:h, :w].astype(np.float32)).cuda()


def phase_fast_fused(summary):
    """The fused K1 on the path's 8-level pyramid, exact."""
    rs = np.random.RandomState(1)
    rand = torch.from_numpy((rs.rand(480, 640) * 255).astype(np.float32))
    worst = 0.0
    for tag, img in (("random", rand.cuda()),
                     ("flat regions", _flat_image(rs, 480, 640))):
        levels = build_pyramid(img, 8, 1.2)
        got = kernels.fast_nms_levels(levels, 7.0, 20.0, 16)
        want = FAST.fast_nms_levels_plain(levels, 7.0, 20.0, 16)
        torch.cuda.synchronize()
        n_kept, n_raw = 0, 0
        for lvl, (g, p) in enumerate(zip(got, want)):
            for name, a, b in zip(("low", "high"), g, p):
                worst = max(worst, float((a - b).abs().max()))
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"fast_nms_levels differs from plain on the {tag} "
                        f"image, level {lvl}, {name} threshold, in "
                        f"{int((a != b).sum())} pixels")
            n_kept += int((g[0] > 0).sum())
            n_raw += int((FAST.fast_score_maps(levels[lvl], [7.0])[0][
                16:-16, 16:-16] > 0).sum())
        print(f"[K1f] fast_nms_levels, {tag} image, 8 levels: both maps of "
              f"every level equal; {n_kept} of {n_raw} low-threshold "
              f"responses inside the border survive the suppression")
        if n_kept <= 0:
            raise AssertionError("the fused FAST kept no response")
    levels = build_pyramid(rand.cuda(), 8, 1.2)
    # what the outputs depend on: scores up to 1 px outside the border mask
    px = sum(h * w for h, w in (x.shape for x in levels))
    px_fast = sum((h - 30) * (w - 30) for h, w in (x.shape for x in levels))
    px_nms = sum((h - 32) * (w - 32) for h, w in (x.shape for x in levels))
    t = _times(summary, "fast_nms_levels",
               lambda reps=1: kernels.fast_nms_levels(levels, 7.0, 20.0, 16,
                                                      reps=reps),
               lambda: FAST.fast_nms_levels_plain(levels, 7.0, 20.0, 16),
               12 * px, FAST_OPS_PX * px_fast + NMS_OPS_PX * px_nms)
    print(f"[K1f] fast_nms_levels 8 levels of 480x640 ({px} px): {t}")
    summary["fast_nms_levels"]["max_abs_err"] = worst


def _k2_inputs(n, m, seed):
    rs = np.random.RandomState(seed)
    dq = rs.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    dt = rs.randint(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    k = min(n, m) // 2
    dt[:k] = dq[:k]
    uv_q = (rs.rand(n, 2) * 640).astype(np.float32)
    uv_t = np.resize(uv_q, (m, 2)) + (rs.randn(m, 2) * 2).astype(np.float32)
    lvl_q = rs.randint(0, 8, n).astype(np.int32)
    lvl_t = rs.randint(0, 8, m).astype(np.int32)
    vq = rs.rand(n) > 0.1
    vt = rs.rand(m) > 0.1
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return dict(uv_q=c(uv_q), level_q=c(lvl_q), valid_q=c(vq),
                desc_q=c(dq.view(np.int32)),
                radius=torch.full((n,), 7.5, device="cuda"),
                uv_t=c(uv_t), level_t=c(lvl_t), valid_t=c(vt),
                desc_t=c(dt.view(np.int32)))


# the callers' gates: (radius, min_off, max_off) of tracking (7.5 here; 15
# on the wide retry), fusion and loop verification
K2_GATES = ((7.5, -1, 1), (3.0, -1, 1), (8.0, 0, 8))


def _k2_args(a, radius):
    return (a["uv_q"], a["level_q"], a["valid_q"], a["desc_q"],
            torch.full_like(a["radius"], radius), a["uv_t"], a["level_t"],
            a["valid_t"], a["desc_t"])


def phase_hamming(summary):
    worst = 0
    for n, m in ((1000, 1000), (2048, 1000), (1256, 1256), (300, 2600)):
        a = _k2_inputs(n, m, seed=n + m)
        for radius, lo, hi in K2_GATES:
            args = _k2_args(a, radius)
            k = kernels.gated_hamming_search(*args, lo, hi, MA.BIG)
            p = MA.gated_hamming_plain(*args, lo, hi)
            torch.cuda.synchronize()
            worst = max(worst, *(int((x - y).abs().max())
                                 for x, y in zip(k, p)))
            for name, x, y in zip(("best", "second", "idx"), k, p):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"gated_hamming_search {name} differs from plain at "
                        f"N={n} M={m}, radius {radius}, window [{lo}, {hi}],"
                        f" in {int((x != y).sum())} rows")
            print(f"[K2] gated_hamming_search N={n} M={m} radius {radius} "
                  f"window [{lo}, {hi}]: equal ({int((k[2] >= 0).sum())} "
                  f"rows with a candidate)")
        args = _k2_args(a, 7.5)
        if n == 2048:
            # a pair costs 13 operations to gate (validity, two differences,
            # two abs, four compares, the level offset, three ands) and, if
            # it passes, 28 more (8 xor, 8 popc, 8 adds, the best-two update)
            gate = (MA.spatial_mask(a["uv_q"], a["uv_t"], a["radius"])
                    & MA.level_mask(a["level_q"], a["level_t"], -1, 1)
                    & a["valid_q"][:, None] & a["valid_t"][None, :])
            n_pass = int(gate.sum())
            t = _times(summary, "gated_hamming_search",
                       lambda reps=1: kernels.gated_hamming_search(
                           *args, -1, 1, MA.BIG, reps=reps),
                       lambda: MA.gated_hamming_plain(*args, -1, 1),
                       n * 49 + m * 45 + n * 12, n * m * 13 + n_pass * 28)
            print(f"[K2] gated_hamming_search N={n} M={m}: {t}; {n_pass} of "
                  f"{n * m} pairs pass the gates")
        elif n == 1256:
            ms = cuda_ms(lambda: kernels.gated_hamming_search(*args, -1, 1,
                                                              MA.BIG))
            dms = device_ms(lambda reps=1: kernels.gated_hamming_search(
                *args, -1, 1, MA.BIG, reps=reps))
            print(f"[K2] gated_hamming_search N={n} M={m}: kernel {ms:.4f} ms "
                  f"with its launcher, {dms:.4f} ms on the device")
    summary["gated_hamming_search"]["max_abs_err"] = float(worst)
    tiny = _k2_args(_k2_inputs(8, 8, seed=8), 7.5)
    floor = min(device_ms(lambda reps=1: kernels.gated_hamming_search(
        *tiny, -1, 1, MA.BIG, reps=reps)) for _ in range(3))
    summary["gated_hamming_search"]["launch_floor_ms"] = floor
    print(f"[K2] launch floor: gated_hamming_search at N = M = 8, "
          f"{floor:.4f} ms on the device")


def _k4_inputs(n, m, seed, dev):
    """Random 256-bit descriptors with ~25% invalid rows and columns, a
    quarter of the queries copied from targets and duplicated targets (index
    ties on best and second)."""
    rs = np.random.RandomState(seed)
    dq = rs.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    dt = rs.randint(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    k = min(n, m) // 4
    dq[:k] = dt[rs.randint(0, m, k)]
    dt[m // 2:m // 2 + m // 8] = dt[:m // 8]
    vq = rs.rand(n) > 0.25
    vt = rs.rand(m) > 0.25
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (c(dq.view(np.int32)), c(vq), c(dt.view(np.int32)), c(vt))


def _check_k4(tag, searches, got):
    """Hold each search of a K4 launch to the plain version, exactly;
    returns the largest |kernel - plain| over its outputs."""
    want = [MA.hamming_best2_plain(*s) for s in searches]
    torch.cuda.synchronize()
    worst = 0
    for i, (g, w) in enumerate(zip(got, want)):
        for name, x, y in zip(("best", "second", "idx"), g, w):
            if x.numel():
                worst = max(worst, int((x - y).abs().max()))
            if not torch.equal(x, y):
                n, m = searches[i][0].shape[0], searches[i][2].shape[0]
                raise AssertionError(
                    f"hamming_best2 {tag}, search {i} (N={n} M={m}): {name} "
                    f"differs from plain in {int((x != y).sum())} rows")
    return worst


def phase_hamming_best2(summary):
    """K4 one search a launch, forward and swapped, and batched tables,
    against the plain version, exact."""
    dev = torch.device("cuda")
    worst = 0
    for n, m in ((1000, 1000), (777, 1013), (2048, 1000), (64, 300)):
        dq, vq, dt, vt = _k4_inputs(n, m, n + m, dev)
        if (n, m) == (64, 300):
            vt = torch.zeros_like(vt)    # no valid target for any row
        for side, args in (("forward", (dq, vq, dt, vt)),
                           ("swapped", (dt, vt, dq, vq))):
            worst = max(worst, _check_k4(
                f"{side} alone", [args],
                [kernels.hamming_best2(*args, MA.BIG)]))
        k = kernels.hamming_best2(dq, vq, dt, vt, MA.BIG)
        print(f"[K4] hamming_best2 N={n} M={m}: forward and swapped equal "
              f"(rows with best == second: {int((k[0] == k[1]).sum())})")
        if (n, m) == (1000, 1000):
            ms = cuda_ms(lambda: kernels.hamming_best2(dq, vq, dt, vt, MA.BIG))
            dms = device_ms(lambda reps=1: kernels.hamming_best2(
                dq, vq, dt, vt, MA.BIG, reps=reps))
            print(f"[K4] hamming_best2 N={n} M={m}, one search: kernel "
                  f"{ms:.4f} ms with its launcher, {dms:.4f} ms on the device")

    # relocalization's table: three candidates, both directions
    cands = [_k4_inputs(1000, 1000, 50 + c, dev) for c in range(3)]
    reloc = cands + [(t, vt, q, vq) for q, vq, t, vt in cands]
    mixed = [_k4_inputs(n, m, n * m, dev)
             for n, m in ((777, 1013), (1013, 777), (2048, 1000), (1, 1),
                          (17, 9))]
    dq, vq, dt, _ = _k4_inputs(64, 300, 3, dev)
    mixed.append((dq, vq, dt, torch.zeros(300, dtype=torch.bool, device=dev)))
    for tag, table in (("reloc table", reloc), ("mixed table", mixed)):
        n0 = kernels.launch_counts["hamming_best2"]
        got = kernels.hamming_best2_many(table, MA.BIG)
        if kernels.launch_counts["hamming_best2"] - n0 != 1:
            raise AssertionError(f"the {tag} took more than one launch")
        worst = max(worst, _check_k4(tag, table, got))
        print(f"[K4] hamming_best2 {tag}, {len(table)} searches in one "
              f"launch: every search equal")
    pairs = 6 * 1000 * 1000
    # the distances are one 1-bit product on the tensor cores, 256
    # multiply-adds (512 operations) a pair, at the int8 rate; on the CUDA
    # cores every pair costs ~8 integer operations: 3 to form the distance
    # from the and-popcount (shift, add, subtract), 2 to pack the index and
    # the validity mask into the key, 3 for the best-two update
    t = _times(summary, "hamming_best2",
               lambda reps=1: kernels.hamming_best2_many(reloc, MA.BIG,
                                                         reps=reps),
               lambda: [MA.hamming_best2_plain(*s) for s in reloc],
               6 * (2000 * 33 + 1000 * 12), pairs * 8, pairs * 512)
    print(f"[K4] hamming_best2 reloc table, 6 x (1000 x 1000): {t}")
    six = cuda_ms(lambda: [kernels.hamming_best2(*s, MA.BIG) for s in reloc])
    print(f"[K4] the same six searches as six launches: {six:.4f} ms with "
          f"the launchers")
    # the distance product alone, as the TPU kernel formed it: +-1 bf16
    # operands unpacked beforehand, [6, 1000, 256] x [6, 256, 1000]
    a = torch.stack([MA.unpack_bits_pm1(s[0]) for s in reloc]).bfloat16()
    b = torch.stack([MA.unpack_bits_pm1(s[2]) for s in reloc]).bfloat16()
    bt = b.transpose(1, 2).contiguous()
    mm = cuda_ms(lambda: torch.matmul(a, bt))
    mm_dev = graph_device_ms(lambda: torch.matmul(a, bt))
    summary["hamming_best2"]["distance_matmul_ms"] = mm_dev
    print(f"[K4] torch.matmul of the +-1 bf16 operands, 6 x (1000 x 256 x "
          f"1000): {mm_dev:.4f} ms on the device, {mm:.4f} ms with its "
          f"dispatch (the product alone; not called by the port)")
    summary["hamming_best2"]["max_abs_err"] = float(worst)


def _lk_inputs(h, w, rs, dev):
    """Smooth random texture [h, w] with a flat patch, the same texture moved
    by an integer shift, N points (~5% near or past the border, a few on the
    flat patch) and guesses up to 3 px off the true motion."""
    big = rs.rand(h // 8 + 4, w // 8 + 4).astype(np.float32) * 255.0
    tex = F.interpolate(torch.from_numpy(big)[None, None].to(dev),
                        size=(h + 32, w + 32), mode="bicubic",
                        align_corners=False)[0, 0]
    tex[8:8 + h // 6, 8:8 + w // 6] = 128.0
    dx, dy = 3, -2
    prev = tex[8:8 + h, 8:8 + w].contiguous()
    nxt = tex[8 - dy:8 - dy + h, 8 - dx:8 - dx + w].contiguous()
    pts = np.stack([rs.rand(LK_N) * (w - 10) + 5,
                    rs.rand(LK_N) * (h - 10) + 5], 1)
    nb = LK_N // 20
    side = rs.randint(0, 2, nb)
    pts[:nb, 0] = np.where(side == 0, rs.rand(nb) * 16 - 8,
                           w - 8 + rs.rand(nb) * 16)
    pts[nb:nb + 20] = rs.rand(20, 2) * [w // 6, h // 6]
    guess = pts + [dx, dy] + rs.uniform(-3, 3, pts.shape)
    c = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return prev, nxt, c(pts), c(guess)


def phase_lk(summary):
    dev = torch.device("cuda")
    rs = np.random.RandomState(3)
    worst = 0.0
    for win in (21, 31):
        for h, w in ((480, 640), (240, 320), (120, 160), (60, 80)):
            prev, nxt, pts, guess = _lk_inputs(h, w, rs, dev)
            args = (prev, nxt, pts, guess, win, 10, 1e-4)
            gk, okk, ek = kernels.lk_level(*args)
            gp, okp, ep = KLT._track_level(*args)
            torch.cuda.synchronize()
            both = okk & okp
            dpts = float((gk - gp).abs().max(dim=1).values[both].max())
            derr = float((ek - ep).abs()[both].max())
            n_diff = int((okk != okp).sum())
            if (h, w, win) == (480, 640, 21):
                t = _times(summary, "lk_level",
                           lambda reps=1: kernels.lk_level(*args, reps=reps),
                           lambda: KLT._track_level(*args),
                           8 * h * w + LK_N * 29,
                           LK_N * lk_point_level_ops(win, 10))
            else:
                ms = cuda_ms(lambda: kernels.lk_level(*args))
                t = f"kernel {ms:.4f} ms with its launcher"
            print(f"[K3] lk_level {h}x{w} win {win}: {int(both.sum())} of "
                  f"{LK_N} ok in both, ok differs on {n_diff}, max |dpts| "
                  f"{dpts:.3e} px, max |derr| {derr:.3e}, {t}")
            if not (dpts <= LK_TOL_PX and derr <= LK_TOL_ERR
                    and n_diff <= LK_TOL_OK * LK_N):
                raise AssertionError(
                    f"lk_level differs from plain at {h}x{w} win {win}")
            if int(both.sum()) < LK_N // 2:
                raise AssertionError(f"lk_level tracked too few points at "
                                     f"{h}x{w} win {win}")
            worst = max(worst, dpts)
    summary["lk_level"]["max_abs_err"] = worst


LK_STREAM_LEVELS = (3, 4)    # the OF stage's 3D-prior and 2D streams


def phase_lk_fused(summary):
    """The fused K3 at the OF stage's shapes against fb_klt_track per
    stream: the first stream starts from guesses up to 3 px off, the second
    at the points themselves (the true motion is (3, -2) px)."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(4)
    prev, nxt, pts, guess = _lk_inputs(480, 640, rs, dev)
    pyr_p = KLT.build_lk_pyramid(prev, 4)
    pyr_n = KLT.build_lk_pyramid(nxt, 4)
    kw = dict(fb_thresh=0.5, fb_levels=1, win=21, iters=10, min_eig=1e-4)
    guesses = [guess, None]

    def fused(reps=1):
        return kernels.lk_pyramid(
            pyr_p, pyr_n, torch.stack([pts, pts]), torch.stack([guess, pts]),
            LK_STREAM_LEVELS, 1, 2.0, 0.5, 21, 10, 1e-4, reps=reps)

    def plain():
        return [KLT.fb_klt_track(pyr_p, pyr_n, pts, g, max_levels=lv,
                                 level_fn=KLT._track_level, **kw)
                for g, lv in zip(guesses, LK_STREAM_LEVELS)]

    n0 = dict(kernels.launch_counts)
    got = KLT.fb_klt_track_streams(pyr_p, pyr_n, pts, guesses,
                                   list(LK_STREAM_LEVELS), **kw)
    if (kernels.launch_counts["lk_pyramid"] - n0["lk_pyramid"] != 1
            or kernels.launch_counts["lk_level"] != n0["lk_level"]):
        raise AssertionError("fb_klt_track_streams on the card did not go "
                             "through one lk_pyramid launch")
    want = plain()
    torch.cuda.synchronize()
    if kernels.launch_counts["lk_level"] != n0["lk_level"]:
        raise AssertionError("the plain version launched the per-level kernel")
    worst = 0.0
    for s, (k, p) in enumerate(zip(got, want)):
        both = k.status & p.status
        dpts = float((k.pts - p.pts).abs().max(dim=1).values[both].max())
        derr = float((k.err - p.err).abs()[both].max())
        n_diff = int((k.status != p.status).sum())
        print(f"[K3f] lk_pyramid stream {s} ({LK_STREAM_LEVELS[s]} + 1 "
              f"levels): {int(both.sum())} of {LK_N} tracked in both, status "
              f"differs on {n_diff}, max |dpts| {dpts:.3e} px, max |derr| "
              f"{derr:.3e}")
        if not (dpts <= LK_TOL_PX and derr <= LK_TOL_ERR
                and n_diff <= LK_TOL_OK * LK_N):
            raise AssertionError(f"lk_pyramid differs from plain on stream "
                                 f"{s}")
        if int(both.sum()) < LK_N // 2:
            raise AssertionError(f"lk_pyramid tracked too few points on "
                                 f"stream {s}")
        worst = max(worst, dpts)
    point_levels = LK_N * sum(lv + 1 for lv in LK_STREAM_LEVELS)
    pyr_bytes = 2 * 4 * sum(x.numel() for x in pyr_p)
    t = _times(summary, "lk_pyramid", fused, plain,
               pyr_bytes + 2 * LK_N * 29,
               point_levels * lk_point_level_ops(21, 10))
    print(f"[K3f] lk_pyramid 2 x {LK_N} points, {point_levels} point-levels:"
          f" {t}")
    summary["lk_pyramid"]["max_abs_err"] = worst


def phase_entry_points(summary):
    """The per-level kernels no longer run on any path; their public entries
    (fast_scores_two, klt_track) still launch them on the card. Driven here
    at full width and counted under a key of their own,
    `entry_point_launches`: `launches` and `launches_per_frame` hold only
    what the five paths counted, which is 0 for these two."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(5)
    prev, nxt, pts, guess = _lk_inputs(480, 640, rs, dev)
    kernels.reset_launch_counts()
    for lv_img in build_pyramid(prev, 8, 1.2):
        lo, hi = FAST.fast_scores_two(lv_img, 7.0, 20.0)
    res = KLT.klt_track(KLT.build_lk_pyramid(prev, 4),
                        KLT.build_lk_pyramid(nxt, 4), pts, guess)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    moved = (res.pts - pts)[res.status].median(dim=0).values
    print(f"[entry] fast_scores_two on 8 levels and klt_track over 4: "
          f"{int(res.status.sum())} of {LK_N} points tracked, median motion "
          f"({float(moved[0]):.3f}, {float(moved[1]):.3f}) px; launches "
          f"{launches}")
    if (launches["fast_scores"] != 8 or launches["lk_level"] != 4
            or not torch.isfinite(lo).all() or not torch.isfinite(hi).all()
            or float((moved - torch.tensor([3.0, -2.0], device=dev)).abs()
                     .max()) > 0.05):
        raise AssertionError("the per-level entry points failed")
    for name in ("fast_scores", "lk_level"):
        summary[name]["entry_point_launches"] = launches[name]


def run_path(tag, cfg, fps, summary, expect):
    """Drive SlamSystem over N_FRAMES frames of the port's synthetic room
    and hold it to the accuracy gates; the kernels in `expect` must have been
    launched by this path. Returns the system."""
    dev = torch.device("cuda")
    cam = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                 width=cfg.frame.orb.width, height=cfg.frame.orb.height)
    seq = SyntheticSequence(SyntheticWorld(cam, device=dev), fps=fps)
    t0 = time.perf_counter()
    frames = []
    for i in range(N_FRAMES):
        gray, depth, (rot_cw, t_cw) = seq.frame(i / fps)
        frames.append((gray, depth, rot_cw.cpu().numpy().astype(np.float64),
                       t_cw.cpu().numpy().astype(np.float64)))
    torch.cuda.synchronize()
    print(f"[{tag}] rendered {N_FRAMES} frames {cam.width}x{cam.height} "
          f"at {fps:g} fps in {time.perf_counter() - t0:.2f} s")

    slam = SlamSystem(cfg, device=dev)
    kernels.reset_launch_counts()
    gt, ms_per_frame = [], []
    for i, (gray, depth, rot_cw, t_cw) in enumerate(frames):
        t = i / fps
        t1 = time.perf_counter()
        slam.track_rgbd(gray, depth, t)
        torch.cuda.synchronize()
        ms_per_frame.append((time.perf_counter() - t1) * 1000.0)
        twc = np.eye(4)
        twc[:3, :3] = rot_cw.T
        twc[:3, 3] = -rot_cw.T @ t_cw
        gt.append((t, twc))
    launches = dict(kernels.launch_counts)

    stats = slam.map_stats()
    traj = slam.trajectory
    poses = np.stack([p for _, p in traj])
    ate = ate_rmse(traj, gt)
    rp = rpe(traj, gt)
    steady = np.asarray(ms_per_frame[1:])
    print(f"[{tag}] state {stats['state']}, {stats['n_kfs']} KFs, "
          f"{stats['n_mps']} map points, {len(traj)} poses, "
          f"ATE {ate['ate_rmse'] * 100:.3f} cm, RPE {rp['rpe_trans'] * 100:.3f}"
          f" cm / {rp['rpe_rot_deg']:.4f} deg")
    print(f"[{tag}] ms/frame (frames 2..{N_FRAMES}): median "
          f"{np.median(steady):.2f}, p90 {np.percentile(steady, 90):.2f}; "
          f"first frame {ms_per_frame[0]:.1f} ms")
    if stats["state"] != "OK":
        raise AssertionError(f"{tag} ended in state {stats['state']}")
    if stats["n_kfs"] < 3:
        raise AssertionError(f"{tag} made only {stats['n_kfs']} keyframes")
    if not np.all(np.isfinite(poses)) or poses.shape[1:] != (4, 4):
        raise AssertionError("non-finite or misshapen poses")
    if not ate["ate_rmse"] < 0.05:
        raise AssertionError(f"ATE {ate['ate_rmse']} m >= 5 cm")
    if not rp["rpe_trans"] < 0.03:
        raise AssertionError(f"RPE {rp['rpe_trans']} m >= 3 cm")
    _count(summary, tag, launches, N_FRAMES, expect)
    return slam


def phase_rgbd(summary):
    run_path("rgbd", SystemConfig(), FPS, summary,
             {"gated_hamming_search": None})


def phase_of_icp(summary):
    base = SystemConfig()
    cfg = dataclasses.replace(
        base, use_of=True, use_icp=True,
        frame=dataclasses.replace(base.frame, n_of_slots=256))
    # the optical-flow stage runs on every frame that has a predecessor
    slam = run_path("of_icp", cfg, OF_FPS, summary,
                    {"gated_hamming_search": None,
                     "lk_pyramid": N_FRAMES - 1})
    n3d, n2d = slam.of_appended
    n_icp = slam.n_icp_accepted
    print(f"[of_icp] OF appended {n3d} 3D-stream and {n2d} 2D-stream points;"
          f" ICP accepted on {n_icp} of {N_FRAMES - 1} frames, carried "
          f"{slam.n_icp_carried}")
    if n3d + n2d <= 0:
        raise AssertionError("the optical-flow stage appended no point")
    if n_icp < 1:
        raise AssertionError("no ICP prediction was accepted")


def _room(cfg, fps):
    cam = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                 width=cfg.frame.orb.width, height=cfg.frame.orb.height)
    return SyntheticSequence(SyntheticWorld(cam, device="cuda"), fps=fps)


def _vocabulary():
    """The shipped vocabulary (k = 10, 4 levels), the port's own asset
    geoflowslam_tpu_torch/assets/vocab_default.npz."""
    t0 = time.perf_counter()
    voc = V.default_vocabulary("cuda")
    print(f"[vocab] shipped vocabulary, k {voc.k}, {voc.levels} levels, "
          f"{voc.n_words} words, loaded in {time.perf_counter() - t0:.2f} s")
    return voc


def _blank(cfg):
    h, w = cfg.frame.orb.height, cfg.frame.orb.width
    return (torch.full((h, w), 100.0, device="cuda"),
            torch.full((h, w), 2.0, device="cuda"))


def _timed(slam, attr, log):
    """Wrap slam.<attr> to append its synchronised wall time (ms) to log."""
    fn = getattr(slam, attr)

    def wrapped(*a, **k):
        t1 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t1) * 1000.0)
        return out
    setattr(slam, attr, wrapped)


def _count(summary, tag, launches, n_frames, expect):
    """Hold a path's launch counts to `expect` (kernel -> exact count, or
    None for at least one): the fused K1 once per frame on every path, the
    per-level K1 and K3 never, any kernel not named not at all."""
    print(f"[{tag}] {n_frames} frames, kernel launches: {launches}")
    expect = {"fast_nms_levels": n_frames, **expect}
    for name, n in launches.items():
        want = expect.get(name, 0)
        if (n <= 0) if want is None else (n != want):
            raise AssertionError(
                f"{tag} launched {name} {n} times over {n_frames} frames, "
                f"expected {'at least once' if want is None else want}")
        summary[name]["launches"] += n
        summary[name]["launches_per_frame"][tag] = n / n_frames


def _tilted(seq, t, pitch):
    """(gray, depth) of the camera at the trajectory's view at time t,
    tilted down by `pitch` about the world's x axis (the floor is at +y)."""
    rot_cw, t_cw = seq.pose_cw(t)
    c, s = float(np.cos(pitch)), float(np.sin(pitch))
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]],
                      device=rot_cw.device)
    pos = -rot_cw.T @ t_cw
    rot2 = (rx @ rot_cw.T).T
    return seq.world.render(rot2, -rot2 @ pos)


def phase_reloc(summary, voc):
    """Relocalization at full width, staged like
    tests/test_reloc_observability.py and tests/test_torch_slice_reloc.py: a
    first pass of 2 s at 10 fps, a tilt in place down to the floor (90
    degrees over 16 frames, so that the last reference KF shares no view
    with the start), blank frames until RECENTLY_LOST, a noisy revisit of
    the view at 0.4 s for up to 3 frames, then 3 clean frames. Neither the
    motion model nor the recovery's 40 px re-search can recover the
    revisit. Gates:
    a relocalization through SlamSystem, state OK with no new map, the pose
    within 10 cm of the first pass's at that view, and K4 launched. The
    relocalization attempts on the revisit frames are timed, and every
    attempt of the path must launch K4 exactly once (its three candidates,
    both directions)."""
    cfg = dataclasses.replace(SystemConfig(), time_recently_lost=30.0,
                              min_kfs_for_new_map=99)
    seq = _room(cfg, RECOVER_FPS)
    slam = SlamSystem(cfg, device="cuda", vocab=voc)
    all_attempts = []
    _timed(slam, "_reloc_attempt", all_attempts)
    kernels.reset_launch_counts()
    first = {}
    for i in range(20):
        g, d, _ = seq.frame(i / RECOVER_FPS)
        first[i] = slam.track_rgbd(g, d, i / RECOVER_FPS)
    t = 2.0
    for k in range(1, 17):
        g, d = _tilted(seq, 1.9, np.pi / 2 * (1 - np.cos(np.pi * k / 16)) / 2)
        slam.track_rgbd(g, d, t)
        t += 0.1
    st = slam.map_stats()
    print(f"[reloc] first pass and tilt: {st}")
    if st["state"] != "OK":
        raise AssertionError(f"reloc first pass ended {st['state']}")
    blank, bdepth = _blank(cfg)
    n_blank = 0
    for _ in range(6):
        slam.track_rgbd(blank, bdepth, t)
        t += 0.1
        n_blank += 1
        if slam.state.name == "RECENTLY_LOST":
            break
    if slam.state.name != "RECENTLY_LOST":
        raise AssertionError(f"blank frames left state {slam.state.name}")
    g, d, _ = seq.frame(0.4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    noisy = torch.clamp(g + 6.0 * torch.randn(g.shape, device="cuda",
                                              generator=gen), 0, 255)
    attempts = []
    _timed(slam, "_reloc_attempt", attempts)
    n_noisy = 0
    t += 1.0
    while n_noisy < 3 and slam.state.name != "OK":
        slam.track_rgbd(noisy, d, t)
        t += 0.1
        n_noisy += 1
    st = slam.map_stats()
    print(f"[reloc] after {n_noisy} noisy frames: {st}, "
          f"{slam.n_reloc} relocalization(s), tracking inliers "
          f"{slam.inlier_log[-1][1:]}")
    if st["state"] != "OK" or st["n_maps"] != 1 or slam.n_reloc < 1:
        raise AssertionError(f"relocalization failed: {st}, "
                             f"{slam.n_reloc} relocalizations")
    for i in (5, 6, 7):
        g, d, _ = seq.frame(i / RECOVER_FPS)
        pose = slam.track_rgbd(g, d, t + 0.5 + i / RECOVER_FPS)
    launches = dict(kernels.launch_counts)
    n_attempts = len(all_attempts)
    err = float(np.linalg.norm(pose[:3, 3] - first[7][:3, 3]))
    st = slam.map_stats()
    print(f"[reloc] after 3 clean frames: {st}, {err * 100:.3f} cm from the "
          f"first pass at that view")
    print(f"[reloc] ms per reloc attempt on the revisit frames: "
          f"{[round(x, 2) for x in attempts]}")
    if st["state"] != "OK" or st["n_maps"] != 1 or not err < 0.1:
        raise AssertionError(f"reloc end state {st}, error {err} m")
    # first pass, tilt, blank, noisy and clean frames
    print(f"[reloc] {n_attempts} relocalization attempts on the path")
    if n_attempts < 1:
        raise AssertionError("the reloc path made no relocalization attempt")
    _count(summary, "reloc", launches, 20 + 16 + n_blank + n_noisy + 3,
           {"hamming_best2": n_attempts, "gated_hamming_search": None})
    # the same relocalization called directly on the lost system's map (after
    # the path's counts were read): the first pass's pose at that view,
    # timed over 5 attempts after one warm-up
    frame = build_frame(noisy, d, cfg.frame, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_inl, rot, tv, _, cand = R.reloc_core(
            voc, slam.reloc_db, slam.ms, frame, slam._reloc_gen, slam.tcfg,
            cfg.frame.orb.width, cfg.frame.orb.height)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1000.0)
    pos = -(rot.T @ tv).cpu().numpy()
    err = float(np.linalg.norm(pos - first[4][:3, 3]))
    print(f"[reloc] direct relocalization of the noisy view: {int(n_inl)} "
          f"inliers via KF {int(cand)}, {err * 100:.3f} cm from the first "
          f"pass; ms per attempt {[round(x, 2) for x in times]}, median of "
          f"the last 5 {np.median(times[1:]):.2f}")
    if int(n_inl) < cfg.min_inliers_ok or not err < 0.1:
        raise AssertionError(f"direct relocalization: {int(n_inl)} inliers, "
                             f"error {err} m")


def phase_merge(summary, voc):
    """Atlas break and merge at full width (tests/test_e2e_loop.py's
    staging) with LoopConfig(): phase A until >= 6 KFs, blank frames until a
    second map starts, then a revisit of phase A's views. Gates: state OK,
    a loop or a merge, >= 90% of the valid KFs in the active map, K2
    launched, and K4 launched exactly once per loop check (Sim3
    verification, both directions) and once per relocalization attempt
    (the blank frames lose the system)."""
    cfg = dataclasses.replace(SystemConfig(), time_recently_lost=0.25,
                              min_kfs_for_new_map=6, loop=LoopConfig())
    seq = _room(cfg, RECOVER_FPS)
    slam = SlamSystem(cfg, device="cuda", vocab=voc)
    checks, attempts = [], []
    _timed(slam.loop_closer, "_verify", checks)
    _timed(slam, "_reloc_attempt", attempts)
    kernels.reset_launch_counts()
    n_a = 0
    while n_a < 22 or (slam.map_stats()["n_kfs"] < 6 and n_a < 60):
        g, d, _ = seq.frame(n_a / RECOVER_FPS)
        slam.track_rgbd(g, d, n_a / RECOVER_FPS)
        n_a += 1
    st = slam.map_stats()
    print(f"[merge] phase A, {n_a} frames: {st}")
    if st["n_kfs"] < 6 or st["state"] != "OK":
        raise AssertionError(f"merge phase A: {st}")
    blank, bdepth = _blank(cfg)
    t = n_a / RECOVER_FPS
    n_blank = 0
    for _ in range(10):
        slam.track_rgbd(blank, bdepth, t)
        t += 0.1
        n_blank += 1
        if slam.map_stats()["n_maps"] >= 2:
            break
    st = slam.map_stats()
    print(f"[merge] after blank frames: {st}")
    if st["n_maps"] < 2:
        raise AssertionError("no second Atlas map")
    lc = slam.loop_closer
    frame_ms, events = [], []
    t += 1.0
    for i in range(n_a):
        g, d, _ = seq.frame(i / RECOVER_FPS)
        before = lc.n_loops + lc.n_merges
        t1 = time.perf_counter()
        slam.track_rgbd(g, d, t + i / RECOVER_FPS)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t1) * 1000.0)
        if lc.n_loops + lc.n_merges > before:
            events.append((i, frame_ms[-1]))
        if events and i >= events[0][0] + 6:
            break
    launches = dict(kernels.launch_counts)
    st = slam.map_stats()
    valid = slam.ms.kf_valid.cpu().numpy()
    share = float((slam.ms.kf_map_id.cpu().numpy()[valid]
                   == int(slam.ms.active_map)).mean())
    print(f"[merge] revisit, {len(frame_ms)} frames: {st}, loops "
          f"{lc.n_loops}, merges {lc.n_merges}, {share * 100:.1f}% of the "
          f"valid KFs in the active map")
    print(f"[merge] ms of the loop-correcting KF frame(s): "
          f"{[(i, round(ms, 2)) for i, ms in events]}; median frame "
          f"{np.median(frame_ms):.2f} ms")
    if st["state"] != "OK" or not events or not share >= 0.9:
        raise AssertionError(f"merge failed: {st}, {len(events)} "
                             f"loop/merge events, KF share {share}")
    print(f"[merge] {len(checks)} loop checks, {len(attempts)} "
          f"relocalization attempts on the path")
    if not checks:
        raise AssertionError("the merge path made no loop check")
    _count(summary, "merge", launches, n_a + n_blank + len(frame_ms),
           {"hamming_best2": len(checks) + len(attempts),
            "gated_hamming_search": None})


def phase_hard(summary, voc):
    """The hard-mode sequence's first HARD_FRAMES frames through the
    hard-mode script's configuration and its pre-rendered m12 buffers
    (tools/run_hardmode.py), the shipped vocabulary, no loop closing. The
    span holds the first fast-rotation bursts and the first texture-poor
    window (contrast under 0.2 from t ~ 4 s to 16 s). Gates: OK with 1 map
    at the end, ATE < 5 cm and RPE < 3 cm on the tracked frames, finite
    poses, no KF-stall warning; the fused K1 once per frame, K2 launched,
    K4 exactly once per relocalization attempt (a wrapper on
    SlamSystem._reloc_attempt counts them)."""
    dev = torch.device("cuda")
    cfg = HM.make_config(640, 480, 1000, loop=False, of=False, icp=False)
    cam = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=640,
                 height=480)
    seq = HardSyntheticSequence(SyntheticWorld(cam, device=dev), fps=FPS)
    ts = np.arange(HARD_FRAMES) / FPS
    rot_cw, t_cw, twc_gt = HM.ground_truth(seq, ts)
    t0 = time.perf_counter()
    bufs = HM.prerender(seq, rot_cw, t_cw, ts)
    print(f"[hard] pre-rendered {HARD_FRAMES} m12 frames 640x480 in "
          f"{time.perf_counter() - t0:.2f} s")
    slam = SlamSystem(cfg, dev, vocab=voc)
    attempts = []
    _timed(slam, "_reloc_attempt", attempts)
    kernels.reset_launch_counts()
    gt, ms_per_frame = [], []
    for i in range(HARD_FRAMES):
        t_abs = 1.4e9 + ts[i]
        t1 = time.perf_counter()
        slam.track_rgbd(bufs[i], None, t_abs)
        torch.cuda.synchronize()
        ms_per_frame.append((time.perf_counter() - t1) * 1000.0)
        gt.append((t_abs, twc_gt[i]))
    launches = dict(kernels.launch_counts)
    stats = slam.map_stats()
    traj = slam.trajectory
    poses = np.stack([p for _, p in traj])
    ate = ate_rmse(traj, gt)
    rp = rpe(traj, gt)
    steady = np.asarray(ms_per_frame[1:])
    print(f"[hard] {stats}, {len(traj)} poses, ATE "
          f"{ate['ate_rmse'] * 100:.3f} cm, RPE {rp['rpe_trans'] * 100:.3f} "
          f"cm / {rp['rpe_rot_deg']:.4f} deg; n_lost {slam.n_lost}, "
          f"n_recovered {slam.n_recovered}, n_reloc {slam.n_reloc}, "
          f"{len(attempts)} relocalization attempts, "
          f"kf_stall_warnings {slam.kf_stall_warnings}")
    print(f"[hard] ms/frame (frames 2..{HARD_FRAMES}): median "
          f"{np.median(steady):.2f}, p90 {np.percentile(steady, 90):.2f}; "
          f"New_KF median {np.median(slam.timers.samples['New_KF']):.2f} ms "
          f"over {len(slam.timers.samples['New_KF'])} KFs")
    if stats["state"] != "OK" or stats["n_maps"] != 1:
        raise AssertionError(f"hard path ended {stats}")
    if not np.all(np.isfinite(poses)) or poses.shape[1:] != (4, 4):
        raise AssertionError("non-finite or misshapen poses")
    if not ate["ate_rmse"] < 0.05:
        raise AssertionError(f"hard ATE {ate['ate_rmse']} m >= 5 cm")
    if not rp["rpe_trans"] < 0.03:
        raise AssertionError(f"hard RPE {rp['rpe_trans']} m >= 3 cm")
    if slam.kf_stall_warnings != 0:
        raise AssertionError(f"{slam.kf_stall_warnings} KF-stall warnings")
    _count(summary, "hard", launches, HARD_FRAMES,
           {"gated_hamming_search": None, "hamming_best2": len(attempts)})


def new_summary():
    return {k: dict(name=k, route="cuda", launches=0, launches_per_frame={},
                    entry_point_launches=0, **v)
            for k, v in KERNEL_INFO.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name = phase_device()
    summary = new_summary()
    phase_build()
    phase_fast(summary)
    phase_fast_fused(summary)
    phase_hamming(summary)
    phase_hamming_best2(summary)
    phase_lk(summary)
    phase_lk_fused(summary)
    phase_entry_points(summary)
    phase_rgbd(summary)
    phase_of_icp(summary)
    voc = _vocabulary()
    phase_reloc(summary, voc)
    phase_merge(summary, voc)
    phase_hard(summary, voc)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_frame", "entry_point_launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "distance_matmul_ms")
    print(json.dumps({
        "kernels": [{k: s[k] for k in keys if k in s}
                    for s in summary.values()],
        "launch_floor_ms": summary["gated_hamming_search"][
            "launch_floor_ms"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
