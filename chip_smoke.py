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
  7. rgbd: N_FRAMES frames at 30 fps of the synthetic room at 640x480, rendered
     by the port, through SlamSystem.track_rgbd with the default
     SystemConfig (1000 features, 8 levels, k_max 256, m_max 65536): state
     OK, >= 3 keyframes, ATE < 5 cm and RPE < 3 cm against ground truth,
     finite poses, K2 launched by the path and the fused K1 exactly once
     per frame;
  8. of_icp: the same with use_of, use_icp and n_of_slots = 256,
     N_FRAMES frames at 10 fps, a fresh map: the same gates, optical-flow points
     appended, at least one accepted ICP prediction, K2 launched, the fused
     K1 exactly once per frame and the fused K3 once per frame after the
     first and once more per staged re-run of a failed frame;
  9. reloc: relocalization at full width with the shipped vocabulary (see
     phase_reloc), through the façade's default (fused) recovery: a
     relocalization brings the lost system back to OK without a new map,
     within 10 cm of the first pass, K4 launched; ms per relocalization
     attempt on the path, and exactly one K4 launch per attempt; then the
     noisy view relocalized directly as well, within 10 cm of the first
     pass, and timed;
 10. merge: an Atlas break and merge at full width with LoopConfig() and
     the shipped vocabulary (see phase_merge): OK, a merge or loop, >= 90%
     of the KFs in the active map, the first loop or merge closed exactly
     `fused_lag` processed frames after the KF whose detection matured
     (both frames printed), K2 launched and exactly one K4 launch per loop
     check and per relocalization attempt; ms of the loop-correcting
     frame;
 11. hard: the first HARD_FRAMES frames (20 s at 30 fps) of the hard-mode
     sequence through the configuration of
     geoflowslam_tpu_torch/tools/run_hardmode.py (640x480, 1000 features, 8
     levels, k_max 128, m_max 32768), packed m12 buffers pre-rendered on the
     card, the shipped vocabulary, no loop closing: state OK and 1 map at
     the end, ATE < 5 cm and RPE < 3 cm on the tracked frames, finite
     poses, no KF-stall warning, the fused K1 once per frame, K2 launched,
     K4 exactly once per relocalization attempt; n_lost, n_recovered (frames
     the recovery step took), n_reloc and ms per frame (median, p90);
 12. inertial: the RGB-D-inertial path at bench.py's configuration
     (inertial_config: the hard phase's widths with fx 400, k_max 256, m_max
     65536, ImuConfig(init_min_kfs=4, init_min_time=0.8), LoopConfig(), the
     shipped vocabulary) over INERTIAL_FRAMES frames (12 s at 30 fps) of
     the synthetic room with 200 Hz IMU samples through
     SlamSystem.track_rgbd_inertial on m12 buffers: OK with 1 map, the IMU
     initialized, VIBA1 and VIBA2 done, ATE over the second half < 5 cm,
     |v| finite and < 3 m/s, the fused K1 once per frame, K2 launched, K4
     exactly once per loop check and relocalization attempt; frames and ms
     per imu_mode (median, p90), the VI accepted share, VI-BA ms per KF by
     window width, host syncs a frame (CUDA sync debugging over 30 frames);
 13. g1: GeoFlow's G1 combination, the default SystemConfig with use_of,
     use_icp (n_of_slots 256), use_lidar and use_odom, through run_path
     (G1_FRAMES frames of the of_icp path's room at 10 fps), the trajectory's
     world velocity queued through set_odom before every frame, frames
     G1_BLANK without texture or depth: the gates of 7, 1 map, ICP
     accepted, OF points appended, the blank frames RECENTLY_LOST and
     odometry read on >= 1 frame, valid plane factors on >= 50% of the
     frames after the second KF, a global map of > 500 points, the fused
     K1 once per frame and K3 once per frame after the first and once
     more per staged re-run; ms a frame, make_plane_obs ms, the frames that
     read odometry;
 14. inertial_geoflow: inertial_config() with use_icp, use_of and
     n_of_slots 256 over INERTIAL_GEOFLOW_FRAMES frames: the gates of 12
     but VIBA2 (7.5 s reach VIBA1 only; host syncs over GEOFLOW_SYNC), ICP
     accepted, OF points appended, >= 1 EdgeICP measurement in a VI-BA
     window (and how many passed their gate), K3 once per frame after the
     first; what 12 prints; then the EdgeICP factor with information on
     the card: on one of the path's VI-BA problems with its measured rows
     at information 1e2 and 1e5, vi_local_ba on the card against the same
     call on the CPU (KF positions within 1e-4 m, rotations within 1e-4
     rad, velocities and biases within 1e-4), rel_pose_terms within 1e-5,
     and the factor moving the KFs at 1e5;
 15. stereo_inertial: examples/run_euroc.py's stereo_imu configuration
     (752x480, fx 458.654, bf 458.654 x 0.11, 1000 features, 8 levels,
     EuRoC's IMU noises, no vocabulary; without its radtan distortion) over
     STEREO_FRAMES frames at 20 fps of a rectified pair through run_path
     (track_stereo, then track_stereo_inertial with 200 Hz samples): the
     gates of 7 with the ATE over the second half < 6 cm, 1 map, the IMU
     initialized, VIBA1 done, |v| < 3 m/s, the fused K1 once per frame, K2
     launched, K4 never; stereo_match on one frame against the rendered
     depth (> 50% valid, median relative error < 5%) and against the CPU
     (masks >= 99% equal, u_right within 1e-3 px); the fused K1 on that
     frame's pyramid equal to plain; ms per imu_mode, VI-BA ms by width,
     host syncs a frame;
 16. stereo_fisheye: the dual-KB8 rig of tests/test_stereo_fisheye.py at
     512x512 (fx 190.44, baseline 0.101 m, lapping (0, 511), 1000 features,
     8 levels) over FISHEYE_FRAMES frames at 20 fps through run_path
     (track_stereo_fisheye): the gates of 7 with ATE < 5 cm at
     with_scale=False, the fused K1 exactly twice a frame, K4 exactly once
     a frame and one frame's K4 search equal to plain; the fused K1 on a
     frame's pyramid equal to plain; K4's times at that frame's shape;
 17. mono: mono_tum's configuration (mono_config: TUM1.yaml's 640x480
     intrinsics, 1000 features, 8 levels, FAST 20/7; without radtan) over
     MONO_FRAMES frames at 30 fps through run_path (track_monocular): the
     gates of 7 with ATE over the last 3/4 < 6 cm at with_scale=True and
     no RPE gate, the init within 30 frames, K1 once a frame, K3 never, K4
     exactly once per init attempt and three times per KF after the
     init's two; K4 equal to plain and timed at the shapes of the first
     init attempt and the first triangulation search;
 18. mono_inertial: examples/run_euroc.py's mono_imu configuration
     (stereo_inertial_config with sensor "mono") at 20 fps on the room at
     1.6x amplitude with 200 Hz IMU, until VIBA1 has run (at most
     MONO_INERTIAL_FRAMES frames): 7-DoF ATE over the last 2/5 < 8 cm, the
     IMU initialized scale_free, VIBA1 with its scale_free re-run of the
     initialization, |v| < 3 m/s, the launch counts of 17; the Sim3 scale
     against ground truth printed.
 19. dataset: a TUM RGB-D-inertial directory exported by io/fixtures at
     640x480 (1000 features, 8 levels) and 10 fps with 200 Hz IMU, run by
     tools/run_rgbd_tum.main --imu over DATASET_FRAMES frames from disk on
     the card (no vocabulary, as the JAX driver runs): OK, the SE3 ATE
     < 6 cm, the shutdown file set; the atlas loaded into a fresh
     SlamSystem with every MapState array equal and refused by one built
     with the shipped vocabulary; DATASET_EXTRA frames in localization
     mode (the KF count frozen, OK) and DATASET_EXTRA after it (KFs
     again); the fused K1 once a frame; the decoder, frame times, the
     atlas's size and save and load seconds.
 20. merge_mesh: the merge path (10) with LoopConfig(run_global_ba=True,
     async_global_ba=True), once without a mesh and once with
     SlamSystem(..., mesh=LandMesh(["cuda:0"] * 4)) (four landmark shards
     on the one card: the sharded step and its reduction; a run across
     cards waits for a machine with more than one): 10's gates and launch
     counts on the mesh run, its asynchronous global BA stepped on the
     mesh, its ATE against ground truth within 2 cm of the run without
     one, the merge's sharded global BA equal to a 1-shard run on its
     input within 1e-3 m, the trajectory within MERGE_MESH_RMS (RMS) of
     the run without a mesh (JAX's 2 cm bound on it fails in JAX too); ms
     of the synchronous sharded global BA.
 21. mesh_gba: tools/dryrun_multichip.py's production map (256 KFs x 512
     observations of 4096 landmarks, m_max 16384) through
     global_ba_step_distributed at ba_pts 4096 on four shards: the median
     landmark error after 2 iterations < 2 cm and within 5e-5 m of the JAX
     dry run's own reading, KF translations within 1e-4
     m of the 1-shard mesh after 5 iterations, no kernel launched; ms per
     iteration (CUDA events) and bytes of partial systems summed per
     iteration at mesh sizes 1 and 4.
 22. mono_geoflow: mono_config() with use_of (256 OF slots) and use_odom,
     MONO_FRAMES frames at 30 fps, the trajectory's world velocity queued
     before every frame: 17's gates and counts, the 7-DoF ATE under
     MONO_GEOFLOW_ATE (the JAX package's reading on the same
     configuration, 6.182 cm, plus 5 mm) in place of 6 cm, the fused K3
     once a frame after the init, OF points appended, the odometry read
     every frame after the init.
 23. quickstart: tools/run_synthetic.main --mode rgbd_inertial --frames
     100 (README's first command, 640x480) and tools/evaluate_ate.main on
     what it wrote: OK, ATE < 5 cm, the two ATEs equal, the fused K1 once a
     frame.
 24. fused_step: pipeline/fused.frame_step on the card at bench.py's
     configuration with ICP, lidar and 256 OF slots (fused_step_config):
     a map tracked over FUSED_FRAMES frames, then the next frame in seven
     variants (off, raw, kf, prior, OF+ICP, OF+ICP+lidar with kf,
     recovery) under torch.cuda.set_sync_debug_mode("error") ("warn" and
     at most one call for the recovery): each tracked, the VI accepted in
     kf and prior, the recovery recovered, the kf poses within 2 cm and
     1 deg of the façade's own step on the frame; host and device ms of
     each (see phase_fused_step).
The paths rgbd, of_icp, g1 (their last PATH_SYNC frames), hard
(HARD_SYNC), inertial (SYNC_WINDOW) and inertial_geoflow (GEOFLOW_SYNC)
count host syncs inside the entry points with CUDA sync debugging, apart
for the frames through the fused frame step without a KF, the fused KF
frames, the frames where a loop candidate matured or the slot mirror
resynced, the staged KF frames and the others (SyncSplit), beside the
readings before the fused step (SYNCS_BEFORE); the fused frames without a
KF must average at most MAX_FUSED_SYNCS on each path, and the fused KF
frames of all of them, pooled, at most MAX_FUSED_KF_SYNCS over at least
MIN_FUSED_KF_FRAMES frames (the sites of the syncs left printed).
Launch counts are read after map_stats() has applied the deferred KF
results (a matured loop check launches K4 and K2).
The inertial path (12) also writes its session before frame SESSION_AT,
restores it into a fresh SlamSystem and drives the last frames again: the
restored counts equal the saved ones, OK with the IMU initialized, the
final position within 5 cm of the unbroken run's and the KF counts within
2 (the JAX package's test_persistence bounds); it prints the file's size,
the save and load seconds and the largest position gap.
Phases 1-6c run in this process. The path phases 7-24 then run in three
processes side by side on the same card (PATH_GROUPS; each a group of
paths one after another, its output printed when it ends), and last, with
the card to itself again, K4 is held to plain and timed at the two shapes
the mono path kept. A path phase runs alone through the module as well,
for example

    python3 -c "import chip_smoke as c; c.phase_build(); \
        s = c.new_summary(); c.phase_mono(s); c.time_mono_k4(s)"

Each phase prints its wall seconds. Each path's launch counts are set to 0
just before it and read just after; every path launches the fused K1 once
per frame (stereo_fisheye twice) and the per-level K1 and K3 never. Every kernel has three times: `ms`, the CUDA-event median around its
Python launcher; `device_ms`, the kernel alone (its C entry launches it 200
and 400 times back to back between one event pair each, and the difference
over 200 is one launch; see device_ms); `plain_ms`; and `bound_ms`, the
least time the card could take, the larger of its bytes over 3.35 TB/s and
its operations over 67 TFLOP/s (K4's distance product: over the tensor
cores' 1,979 TOP/s), worked out from this run's inputs. No
PyTorch call computes any of these functions, so `library_ms` is null. The
line before the last is a JSON summary of the kernels (`launches` summed
over the eighteen paths and nothing else, and K4's `path_shapes`) with
`launch_floor_ms` beside it; the
last line is {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import torch.nn.functional as F

from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.config import (FrameConfig, ImuConfig, LoopConfig,
                                          MappingConfig, OrbConfig,
                                          StereoFisheyeConfig, SystemConfig)
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe
from geoflowslam_tpu_torch.io import feed_codec as FC
from geoflowslam_tpu_torch.io.synthetic import (Camera, HardSyntheticSequence,
                                                SyntheticSequence,
                                                SyntheticWorld,
                                                smooth_trajectory)
from geoflowslam_tpu_torch.ops import fast as FAST
from geoflowslam_tpu_torch.ops import klt as KLT
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.ops import matching as MA
from geoflowslam_tpu_torch.ops import stereo as ST
from geoflowslam_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from geoflowslam_tpu_torch.parallel import dist_ba
from geoflowslam_tpu_torch.parallel.dist_ba import LandMesh
from geoflowslam_tpu_torch.imu import preintegration as PRE
from geoflowslam_tpu_torch.pipeline import fused as FU
from geoflowslam_tpu_torch.pipeline import lidar_mapping as LD
from geoflowslam_tpu_torch.pipeline import local_mapping as LM
from geoflowslam_tpu_torch.pipeline import mono_init as MI
from geoflowslam_tpu_torch.pipeline import reloc as R
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.retrieval import vocab as V
from geoflowslam_tpu_torch.solvers import inertial_ba as VIBA
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
N_FRAMES = 90      # the rgbd and of_icp paths (150 before the stereo paths)
G1_FRAMES = 150
FPS = 30.0
OF_FPS = 10.0
G1_BLANK = (20, 21)   # g1 frames without texture or depth (odometry read)
RECOVER_FPS = 10.0   # the reloc and merge paths, as their JAX tests stage them
HARD_FRAMES = 600    # the hard path: 20 s, into the first texture-poor window
HARD_SYNC = (60, 90)   # hard frames whose host syncs are counted
INERTIAL_FRAMES = 360   # the inertial path: 12 s at 30 fps (IMU init ~1 s,
                        # VIBA1 at +5 s, VIBA2 at +10 s); 420 before the
                        # stereo paths came
SYNC_WINDOW = (300, 330)   # inertial frames whose host syncs are counted
SESSION_AT = 300   # the inertial path's session checkpoint, before frame 300
# the dataset path: a TUM directory exported at 10 fps, the driver over its
# first DATASET_FRAMES frames, then DATASET_EXTRA frames in localization
# mode and DATASET_EXTRA after it
DATASET_FRAMES = 60
DATASET_EXTRA = 20
DATASET_FPS = 10.0
# the inertial path with GeoFlow's streams: 7.5 s at 30 fps, through VIBA1
# (init ~1.1 s, VIBA1 at +5 s), its host syncs counted over GEOFLOW_SYNC;
# 360 frames (VIBA2) took the whole script near the time limit, 240 before
# the stereo paths came
INERTIAL_GEOFLOW_FRAMES = 225
GEOFLOW_SYNC = (190, 220)
# the stereo-inertial path (examples/run_euroc.py's stereo_imu configuration):
# 8.5 s at 20 fps, through the init (1.5 s on an H100) and VIBA1 (the first
# KF 5 s later); host syncs counted over STEREO_SYNC
STEREO_FRAMES = 170
STEREO_FPS = 20.0
STEREO_SYNC = (150, 160)
FISHEYE_FRAMES = 110   # the stereo-fisheye path: 5.5 s at 20 fps
FISHEYE_FPS = 20.0
# the monocular paths: mono_tum at 30 fps, 4 s; mono-inertial at EuRoC's
# 20 fps until VIBA1 (the init ~2.5 s, VIBA1 at the first KF past 5 s
# later), at most 9 s, on the room's trajectory at MONO_INERTIAL_SCALE x
# its amplitude: at 1.2 x (tests/test_e2e_mono_inertial.py's, at 10 fps)
# the initialization's scale solve stays unstable at 20 fps for ~4.6 s,
# in the JAX package too, and VIBA1 falls past 9 s
MONO_FRAMES = 120
MONO_FPS = 30.0
MONO_INERTIAL_FRAMES = 180
MONO_INERTIAL_FPS = 20.0
MONO_INERTIAL_SCALE = 1.6
MESH_SHARDS = 4      # the mesh paths' landmark shards, all on the one card
QUICK_FRAMES = 100   # README's first command: run_synthetic --frames 100
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
    what the paths counted, which is 0 for these two."""
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


def run_path(tag, cfg, fps, summary, expect, render=None, track=None,
             n_frames=N_FRAMES, cam=None, ate_gate=0.05, tail=1.0,
             with_scale=True, rpe_gate=0.03, stop=None, scale=1.0,
             init=None, sync=None):
    """Drive SlamSystem over n_frames of the port's synthetic room (the
    camera `cam`, by default cfg's pinhole; the trajectory's amplitude
    `scale`) and hold it to the accuracy gates: state OK, >= 3 KFs, finite
    poses, ATE < ate_gate (over the last `tail` of the frames; with_scale
    as ate_rmse takes it) and RPE < rpe_gate (None: printed only); the
    kernels in `expect` (or in expect(slam) when it is callable) must have
    been launched by this path. The frame source: `render(seq, i, t)`
    returns frame i's inputs, all rendered before the first frame is
    tracked (default: the room's gray and depth), and `track(slam, i, t,
    inputs)` tracks it (default: track_rgbd; a hook may queue odometry,
    pass a second image or IMU samples); the run ends early after the
    first frame i for which `stop(slam, i)` holds; `init(slam)` sees the
    system before its first frame. With `sync` = (first, end) the host
    syncs of frames first..end-1 are counted by kind (SyncSplit, gated),
    and those frames are left out of the times. Returns the system."""
    dev = torch.device("cuda")
    if cam is None:
        cam = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                     width=cfg.frame.orb.width, height=cfg.frame.orb.height)
    if render is None:
        render = lambda seq, i, t: seq.frame(t)[:2]
    if track is None:
        track = lambda slam, i, t, inputs: slam.track_rgbd(*inputs, t)
    seq = SyntheticSequence(SyntheticWorld(cam, device=dev), fps=fps,
                            scale=scale)
    t0 = time.perf_counter()
    frames, gt = [], []
    for i in range(n_frames):
        frames.append(render(seq, i, i / fps))
        rot_cw, t_cw = (x.cpu().numpy().astype(np.float64)
                        for x in seq.pose_cw(i / fps))
        twc = np.eye(4)
        twc[:3, :3] = rot_cw.T
        twc[:3, 3] = -rot_cw.T @ t_cw
        gt.append((i / fps, twc))
    torch.cuda.synchronize()
    print(f"[{tag}] rendered {n_frames} frames {cam.width}x{cam.height} "
          f"at {fps:g} fps in {time.perf_counter() - t0:.2f} s")

    slam = SlamSystem(cfg, device=dev)
    if init is not None:
        init(slam)
    split = SyncSplit(slam) if sync is not None else None
    kernels.reset_launch_counts()
    ms_per_frame = []
    for i, inputs in enumerate(frames):
        if split is not None:
            split.active = sync[0] <= i < sync[1]
        t1 = time.perf_counter()
        track(slam, i, i / fps, inputs)
        torch.cuda.synchronize()
        if split is None or not split.active:
            ms_per_frame.append((time.perf_counter() - t1) * 1000.0)
        if stop is not None and stop(slam, i):
            n_frames, gt = i + 1, gt[:i + 1]
            break
    launches = _settled_launches(slam)

    stats = slam.map_stats()
    traj = slam.trajectory
    poses = np.stack([p for _, p in traj])
    first = n_frames - int(round(n_frames * tail))
    ate = ate_rmse([e for e in traj if e[0] >= gt[first][0]], gt[first:],
                   with_scale=with_scale)
    slam.ate = ate
    rp = rpe(traj, gt)
    steady = np.asarray(ms_per_frame[1:])
    print(f"[{tag}] state {stats['state']}, {stats['n_kfs']} KFs, "
          f"{stats['n_mps']} map points, {len(traj)} poses, "
          f"ATE{f' over the last {tail:g}' if tail < 1.0 else ''} "
          f"{ate['ate_rmse'] * 100:.3f} cm"
          f"{' (7 DoF)' if with_scale else ''}, RPE "
          f"{rp['rpe_trans'] * 100:.3f} cm / {rp['rpe_rot_deg']:.4f} deg")
    print(f"[{tag}] ms/frame (frames 2..{n_frames}"
          f"{'' if sync is None else ' but the counted ones'}): median "
          f"{np.median(steady):.2f}, p90 {np.percentile(steady, 90):.2f}; "
          f"first frame {ms_per_frame[0]:.1f} ms")
    if stats["state"] != "OK":
        raise AssertionError(f"{tag} ended in state {stats['state']}")
    if stats["n_kfs"] < 3:
        raise AssertionError(f"{tag} made only {stats['n_kfs']} keyframes")
    if not np.all(np.isfinite(poses)) or poses.shape[1:] != (4, 4):
        raise AssertionError("non-finite or misshapen poses")
    if not ate["ate_rmse"] < ate_gate:
        raise AssertionError(f"ATE {ate['ate_rmse']} m >= {ate_gate} m")
    if rpe_gate is not None and not rp["rpe_trans"] < rpe_gate:
        raise AssertionError(f"RPE {rp['rpe_trans']} m >= {rpe_gate} m")
    slam.ms_per_frame = ms_per_frame
    _count(summary, tag, launches, n_frames,
           expect(slam) if callable(expect) else expect)
    if split is not None:
        split.report(tag, sync[0], sync[1] - 1)
    return slam


PATH_SYNC = 30   # the last frames of rgbd, of_icp and g1 whose syncs count


def _last(n_frames):
    return (n_frames - PATH_SYNC, n_frames)


def phase_rgbd(summary):
    run_path("rgbd", SystemConfig(), FPS, summary,
             {"gated_hamming_search": None}, sync=_last(N_FRAMES))


def phase_of_icp(summary):
    base = SystemConfig()
    cfg = dataclasses.replace(
        base, use_of=True, use_icp=True,
        frame=dataclasses.replace(base.frame, n_of_slots=256))
    # the optical-flow stage runs on every frame that has a predecessor,
    # and again on a failed frame's staged re-run
    slam = run_path("of_icp", cfg, OF_FPS, summary,
                    lambda s: {"gated_hamming_search": None,
                               "lk_pyramid": N_FRAMES - 1
                               + s.n_staged_reruns},
                    sync=_last(N_FRAMES))
    n3d, n2d = slam.of_appended
    n_icp = slam.n_icp_accepted
    print(f"[of_icp] OF appended {n3d} 3D-stream and {n2d} 2D-stream points;"
          f" ICP accepted on {n_icp} of {N_FRAMES - 1} frames, carried "
          f"{slam.n_icp_carried}")
    if n3d + n2d <= 0:
        raise AssertionError("the optical-flow stage appended no point")
    if n_icp < 1:
        raise AssertionError("no ICP prediction was accepted")


def phase_g1(summary):
    """GeoFlow's G1 combination at full width: the default SystemConfig
    with use_of, use_icp (n_of_slots 256), use_lidar and use_odom, through
    run_path over G1_FRAMES frames of the of_icp path's room at 10 fps, no
    vocabulary, the trajectory's world velocity queued through
    set_odom(v, odom_frame=False) before every frame, and frames G1_BLANK
    blank (gray flat at 100, no depth: the registration fails with the
    visual track), so that the frames that fail or start RECENTLY_LOST
    take the staged step, which predicts from the odometry. Gates: those of
    run_path, 1 map, >= 1 accepted ICP prediction, optical-flow points
    appended, the blank frames lost and odometry read on >= 1 frame,
    valid plane factors on >= 50% of the frames after the second KF, a
    global map of > 500 points, the fused K1 exactly once per frame, the
    fused K3 once per frame after the first and once more per staged
    re-run (the blank frame that fails the fused step), K2 launched. Prints
    ms per
    frame (median, p90), make_plane_obs ms (synchronised, median, p90) and
    the frames whose prediction read odometry."""
    base = SystemConfig()
    cfg = dataclasses.replace(
        base, use_of=True, use_icp=True, use_lidar=True, use_odom=True,
        frame=dataclasses.replace(base.frame, n_of_slots=256))
    n_kfs, states = [], {}

    def track(slam, i, t, inputs):
        gray, depth = inputs
        if i > 0:
            n_kfs.append(int(slam.ms.kf_valid.sum()))
            states[i - 1] = slam.state.name
        slam.set_odom(smooth_trajectory(torch.tensor(t))[2].numpy(),
                      odom_frame=False)
        if i in G1_BLANK:
            gray, depth = torch.full_like(gray, 100.0), torch.zeros_like(depth)
        slam.track_rgbd(gray, depth, t)
    plane_ms = []
    make_plane_obs = LD.make_plane_obs

    def timed_plane_obs(*a, **k):
        t1 = time.perf_counter()
        out = make_plane_obs(*a, **k)
        torch.cuda.synchronize()
        plane_ms.append((time.perf_counter() - t1) * 1e3)
        return out
    LD.make_plane_obs = timed_plane_obs
    try:
        slam = run_path("g1", cfg, OF_FPS, summary,
                        lambda s: {"gated_hamming_search": None,
                                   "lk_pyramid": G1_FRAMES - 1
                                   + s.n_staged_reruns}, track=track,
                        n_frames=G1_FRAMES, sync=_last(G1_FRAMES))
    finally:
        LD.make_plane_obs = make_plane_obs
    n_kfs.append(int(slam.ms.kf_valid.sum()))
    stats = slam.map_stats()
    n3d, n2d = slam.of_appended
    second = next((i for i, k in enumerate(n_kfs) if k >= 2), G1_FRAMES)
    counts = dict(slam.plane_factor_counts)
    after = [counts.get(round(i / OF_FPS, 4), 0)
             for i in range(second + 1, G1_FRAMES)]
    share = float(np.mean([c > 0 for c in after])) if after else 0.0
    n_global = len(slam.global_map.points())
    lost = [states.get(i) for i in G1_BLANK]
    print(f"[g1] {stats}; ICP accepted on {slam.n_icp_accepted} frames, "
          f"carried {slam.n_icp_carried}; OF appended {n3d} 3D-stream and "
          f"{n2d} 2D-stream points; blank frames {list(G1_BLANK)} ended "
          f"{lost}")
    print(f"[g1] plane factors valid on {share * 100:.1f}% of the "
          f"{len(after)} frames after the second KF (median "
          f"{np.median(after) if after else 0:.0f} a frame); global map "
          f"{n_global} points; odometry read on {slam.n_odom_frames} "
          f"frames, {len(slam._odom_queue)} samples left in the queue")
    print(f"[g1] make_plane_obs median {np.median(plane_ms):.3f} ms, p90 "
          f"{np.percentile(plane_ms, 90):.3f} ms over {len(plane_ms)} calls")
    if stats["n_maps"] != 1:
        raise AssertionError(f"g1 path ended {stats}")
    if slam.n_icp_accepted < 1 or n3d + n2d <= 0:
        raise AssertionError("no ICP prediction accepted or no OF point")
    if any(x != "RECENTLY_LOST" for x in lost) or slam.n_odom_frames < 1:
        raise AssertionError(f"blank frames ended {lost}, odometry read on "
                             f"{slam.n_odom_frames} frames")
    if not share >= 0.5 or n_global <= 500:
        raise AssertionError(f"plane factors on {share} of the frames, "
                             f"global map {n_global} points")


def stereo_inertial_config() -> SystemConfig:
    """examples/run_euroc.py's configuration for --mode stereo_imu
    (examples/run_euroc.py:56-66): EuRoC cam0, 752x480, fx 458.654 / fy
    457.296, bf = 458.654 x 0.11, 1000 features, 8 levels, ImuConfig with
    EuRoC's noises and the default initialization; cut: dist_params=()
    (the room's renderer has no radtan model)."""
    orb = OrbConfig(n_features=1000, n_levels=8, height=480, width=752)
    bf = 458.654 * 0.11
    return SystemConfig(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375, bf=bf,
        frame=FrameConfig(orb=orb, bf=bf),
        imu=ImuConfig(freq=200.0, noise_gyro=1.7e-4, noise_acc=2e-3,
                      walk_gyro=1.9e-5, walk_acc=3e-3))


def _check_stereo_depth(seq, cfg, t):
    """One frame of the rectified rig at time t: stereo_match's depth on the
    left keypoints against the rendered depth (> 50% valid, median relative
    error < 5%), and the card's matcher against the same call on the CPU
    (valid masks >= 99% equal, u_right within 1e-3 px where both are
    valid); returns its ms on the card."""
    rot_cw, t_cw = seq.pose_cw(t)
    gl, depth = seq.world.render(rot_cw, t_cw)
    gr, _ = seq.world.render(rot_cw, t_cw + _baseline(cfg))
    frame = build_frame(gl, None, cfg.frame, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    uv, valid = frame.feat.uv, frame.feat.valid
    ur, d = ST.stereo_match(gl, gr, uv, valid, cfg.bf)
    ur_c, d_c = ST.stereo_match(gl.cpu(), gr.cpu(), uv.cpu(), valid.cpu(),
                                cfg.bf)
    ok, ok_c = (d > 0).cpu(), d_c > 0
    xi = torch.round(uv[:, 0]).long().clamp(0, gl.shape[1] - 1)
    yi = torch.round(uv[:, 1]).long().clamp(0, gl.shape[0] - 1)
    gt = depth[yi, xi]
    share = float(ok[valid.cpu()].float().mean())
    rel = float(((d - gt).abs() / gt)[d > 0].median())
    agree = float((ok == ok_c).float().mean())
    both = ok & ok_c
    du = float((ur.cpu() - ur_c)[both].abs().max())
    ms = cuda_ms(lambda: ST.stereo_match(gl, gr, uv, valid, cfg.bf))
    print(f"[stereo_inertial] stereo_match at t = {t} s: depth on "
          f"{share * 100:.1f}% of {int(valid.sum())} keypoints, median "
          f"relative error {rel * 100:.3f}% against the rendered depth; card "
          f"against CPU: valid masks equal on {agree * 100:.2f}%, max "
          f"|u_right| difference {du:.2e} px; {ms:.3f} ms on the card")
    if not (share > 0.5 and rel < 0.05):
        raise AssertionError(f"stereo depth on {share} of the keypoints, "
                             f"median relative error {rel}")
    if not (agree >= 0.99 and du <= 1e-3):
        raise AssertionError(f"stereo_match on the card differs from the "
                             f"CPU: masks {agree}, u_right {du} px")
    return ms


def _baseline(cfg):
    """The rectified right camera's offset in Tcw: (-bf / fx, 0, 0)."""
    return torch.tensor([-cfg.bf / cfg.fx, 0.0, 0.0], device="cuda")


def _check_fused_k1(seq, t, tag):
    """The fused K1 against its plain version on the pyramid of one frame
    of the path, every level's maps torch.equal; returns (device ms, bound
    ms, its limit)."""
    gray = torch.nan_to_num(seq.frame(t)[0], nan=0.0)
    levels = build_pyramid(gray, 8, 1.2)
    got = kernels.fast_nms_levels(levels, 7.0, 20.0, 16)
    want = FAST.fast_nms_levels_plain(levels, 7.0, 20.0, 16)
    torch.cuda.synchronize()
    for lvl, (g, p) in enumerate(zip(got, want)):
        if not all(torch.equal(a, b) for a, b in zip(g, p)):
            raise AssertionError(f"fast_nms_levels differs from plain on a "
                                 f"{tag} frame, level {lvl}")
    h, w = gray.shape
    px = sum(x.numel() for x in levels)
    px_fast = sum((a - 30) * (b - 30) for a, b in (x.shape for x in levels))
    px_nms = sum((a - 32) * (b - 32) for a, b in (x.shape for x in levels))
    dms = device_ms(lambda reps=1: kernels.fast_nms_levels(
        levels, 7.0, 20.0, 16, reps=reps))
    bms, by = bound_ms(12 * px, FAST_OPS_PX * px_fast + NMS_OPS_PX * px_nms)
    print(f"[{tag}] fast_nms_levels on a {w}x{h} frame's 8 levels: equal to "
          f"plain; {dms:.4f} ms on the device, bound {bms:.5f} ms ({by})")
    return dms, bms, by


def phase_stereo_inertial(summary, n_frames: int = STEREO_FRAMES):
    """Stereo-inertial at examples/run_euroc.py's stereo_imu configuration
    (stereo_inertial_config) through run_path: n_frames of the room at 20
    fps, the right image of a rectified pair 0.11 m to the right, 200 Hz
    IMU samples (10 a frame), no vocabulary; the first frame through
    track_stereo, then track_stereo_inertial. Gates: those of run_path
    with the ATE over the second half < 6 cm, 1 map, the IMU initialized
    and VIBA1 done, |v| finite and < 3 m/s, the fused K1 once per frame, K2
    launched, K4 never; then _check_stereo_depth on one frame and the fused
    K1 on one frame's pyramid against plain. Prints ms a frame per
    imu_mode (median, p90), VI-BA ms by window width and the host syncs a
    frame over STEREO_SYNC (CUDA sync debugging)."""
    cfg = stereo_inertial_config()
    base = _baseline(cfg)
    seqs, by_mode, viba, n_syncs = [], {}, [], [0]

    def render(seq, i, t):
        if not seqs:
            seqs.append(seq)
        rot_cw, t_cw = seq.pose_cw(t)
        imu = None if i == 0 else tuple(
            x.cpu().numpy() for x in seq.imu_between(
                (i - 1) / STEREO_FPS, t, cfg.imu.max_samples_per_frame))
        return (seq.world.render(rot_cw, t_cw)[0],
                seq.world.render(rot_cw, t_cw + base)[0], imu)

    def track(slam, i, t, inputs):
        gl, gr, imu = inputs
        before = dict(slam.imu_modes)
        t1 = time.perf_counter()
        if i == 0:
            slam.track_stereo(gl, gr, t)
        elif STEREO_SYNC[0] <= i < STEREO_SYNC[1]:
            n_syncs[0] += _count_syncs(
                lambda: slam.track_stereo_inertial(gl, gr, *imu, t))[1]
            return
        else:
            slam.track_stereo_inertial(gl, gr, *imu, t)
        torch.cuda.synchronize()
        mode = next((m for m, n in slam.imu_modes.items()
                     if n != before.get(m, 0)), "init")
        by_mode.setdefault(mode, []).append(
            (time.perf_counter() - t1) * 1000.0)

    vi_ba_step = LM.vi_ba_step

    def timed_vi_ba(ms, win, mcfg):
        t1 = time.perf_counter()
        out = vi_ba_step(ms, win, mcfg)
        torch.cuda.synchronize()
        viba.append((win.slots.shape[0], (time.perf_counter() - t1) * 1e3))
        return out
    LM.vi_ba_step = timed_vi_ba
    try:
        slam = run_path("stereo_inertial", cfg, STEREO_FPS, summary,
                        {"gated_hamming_search": None}, render, track,
                        n_frames, ate_gate=0.06, tail=0.5)
    finally:
        LM.vi_ba_step = vi_ba_step
    imu_t = slam.imu
    v = imu_t.body.v.cpu().numpy()
    stats = slam.map_stats()
    n_vi = sum(n for m, n in slam.imu_modes.items() if m in ("kf", "prior"))
    print(f"[stereo_inertial] {stats}; IMU initialized {imu_t.initialized} "
          f"at t = {imu_t.init_time} s, VIBA1 {imu_t.viba1_done}, VIBA2 "
          f"{imu_t.viba2_done}; |v| {np.linalg.norm(v):.3f} m/s; n_lost "
          f"{slam.n_lost}; frames per imu_mode {slam.imu_modes}; VI accepted "
          f"on {slam.n_vi_accepted} of {n_vi} VI frames")
    for mode, v_ms in sorted(by_mode.items()):
        print(f"[stereo_inertial] ms/frame in mode {mode}: median "
              f"{np.median(v_ms):.2f}, p90 {np.percentile(v_ms, 90):.2f} "
              f"over {len(v_ms)} frames")
    for kw in sorted({k for k, _ in viba}):
        v_kw = [m for k, m in viba if k == kw]
        print(f"[stereo_inertial] VI-BA kw {kw}: {len(v_kw)} runs, median "
              f"{np.median(v_kw):.2f} ms, max {np.max(v_kw):.2f} ms")
    n_win = STEREO_SYNC[1] - STEREO_SYNC[0]
    print(f"[stereo_inertial] host syncs a frame over frames "
          f"{STEREO_SYNC[0]}..{STEREO_SYNC[1] - 1}: {n_syncs[0] / n_win:.2f}")
    if stats["n_maps"] != 1:
        raise AssertionError(f"stereo_inertial path ended {stats}")
    if not (imu_t.initialized and imu_t.viba1_done):
        raise AssertionError("IMU initialization or VIBA1 missing")
    if not (np.all(np.isfinite(v)) and np.linalg.norm(v) < 3.0):
        raise AssertionError(f"velocity {v}")
    _check_stereo_depth(seqs[0], cfg, 1.0)
    _check_fused_k1(seqs[0], 1.0, "stereo_inertial")


KB8_L = (0.0035, 0.0007, -0.002, 0.0002)   # tests/test_stereo_fisheye.py
KB8_R = (0.0034, 0.0018, -0.0027, 0.0003)


def stereo_fisheye_config():
    """The TUM-VI-like dual-KB8 rig of tests/test_stereo_fisheye.py at
    512x512: fx = fy = 190.44, the left camera KB8_L, the right camera
    offset as in the test (fx + 0.5, fy + 0.3, cx - 1, cy + 0.5) with
    KB8_R, baseline 0.101 m with a small rotation, lapping (0, 511), 1000
    features, 8 levels, sensor "stereo", the test's KF policy
    (kf_min_interval 1, kf_max_interval 4), no IMU. Returns (SystemConfig,
    the right camera)."""
    f, w = 190.44, 512
    r_lr = lie.so3_exp(torch.tensor([0.002, -0.001, 0.0008])).numpy()
    t_lr = (0.101, 0.002, 0.001)
    right = Camera(fx=f + 0.5, fy=f + 0.3, cx=w / 2 - 1.0, cy=w / 2 + 0.5,
                   width=w, height=w, kb8=KB8_R)
    sf = StereoFisheyeConfig(
        params_r=(right.fx, right.fy, right.cx, right.cy, *KB8_R),
        r_lr=tuple(float(x) for x in r_lr.reshape(-1)), t_lr=t_lr,
        lapping_l=(0.0, 511.0), lapping_r=(0.0, 511.0))
    orb = OrbConfig(n_features=1000, n_levels=8, height=w, width=w)
    fc = FrameConfig(orb=orb, bf=f * 0.101, camera_model="kb8",
                     dist_params=KB8_L)
    return SystemConfig(fx=f, fy=f, cx=w / 2, cy=w / 2, bf=f * 0.101,
                        frame=fc, sensor="stereo", stereo_fisheye=sf,
                        kf_min_interval=1, kf_max_interval=4), right


def phase_stereo_fisheye(summary, n_frames: int = FISHEYE_FRAMES):
    """Stereo-fisheye at full width (stereo_fisheye_config) through
    run_path: n_frames of the room at 20 fps, both images ray-cast through
    their KB8 models, track_stereo_fisheye. Gates: those of run_path with
    ATE < 5 cm at with_scale=False (the metric scale from the rig), the
    fused K1 exactly twice a frame (the left and the right image), K4
    exactly once a frame (the left x right search) and, on one frame, that
    launch's search torch.equal to hamming_best2_plain; then the fused K1
    on one frame's pyramid against plain, and K4's times at that frame's
    shape."""
    cfg, right = stereo_fisheye_config()
    sf = cfg.stereo_fisheye
    rot_rl = torch.tensor(sf.r_lr, device="cuda").reshape(3, 3).T
    t_rl = -rot_rl @ torch.tensor(sf.t_lr, device="cuda")
    world_r = SyntheticWorld(right, device="cuda")
    seqs, spied = [], []

    def render(seq, i, t):
        # the corner pixels' rays pass 90 degrees (theta_d > pi / 2 beyond
        # 299 px from the centre); one that hits no wall renders NaN, black
        # here as outside a real fisheye's image circle
        if not seqs:
            seqs.append(seq)
        rot_cw, t_cw = seq.pose_cw(t)
        return tuple(torch.nan_to_num(g, nan=0.0) for g in (
            seq.world.render(rot_cw, t_cw)[0],
            world_r.render(rot_rl @ rot_cw, rot_rl @ t_cw + t_rl)[0]))

    launch = kernels.hamming_best2_many

    def spy(searches, big, **kw):
        out = launch(searches, big, **kw)
        spied.append((searches, out))
        return out

    def track(slam, i, t, inputs):
        if i == n_frames // 2:
            kernels.hamming_best2_many = spy
        try:
            slam.track_stereo_fisheye(*inputs, t)
        finally:
            kernels.hamming_best2_many = launch
    left = Camera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=512,
                  height=512, kb8=KB8_L)
    slam = run_path("stereo_fisheye", cfg, FISHEYE_FPS, summary,
                    {"fast_nms_levels": 2 * n_frames,
                     "gated_hamming_search": None,
                     "hamming_best2": n_frames},
                    render, track, n_frames, cam=left, with_scale=False)
    if len(spied) != 1 or len(spied[0][0]) != 1:
        raise AssertionError(f"frame {n_frames // 2} made {len(spied)} K4 "
                             f"launches")
    searches, got = spied[0]
    worst = _check_k4("stereo_fisheye frame", searches, got)
    (dq, vq, dt, vt), = searches
    n, m = int(vq.sum()), int(vt.sum())
    dms = device_ms(lambda reps=1: kernels.hamming_best2_many(
        searches, MA.BIG, reps=reps))
    pms = cuda_ms(lambda: MA.hamming_best2_plain(*searches[0]))
    pairs = dq.shape[0] * dt.shape[0]
    bms, by = bound_ms(dq.shape[0] * 33 + dt.shape[0] * 33
                       + dq.shape[0] * 12, pairs * 8, pairs * 512)
    print(f"[stereo_fisheye] K4 on frame {n_frames // 2}: {dq.shape[0]} x "
          f"{dt.shape[0]} ({n} x {m} valid, in the lapping areas), equal to "
          f"plain (max_abs_err {worst}); {dms:.4f} ms on the device, plain "
          f"{pms:.4f} ms, bound {bms:.5f} ms ({by})")
    print(f"[stereo_fisheye] {slam.map_stats()}; n_lost {slam.n_lost}")
    _check_fused_k1(seqs[0], 1.0, "stereo_fisheye")


def mono_config(scale: float = 1.0, of: bool = False,
                odom: bool = False) -> SystemConfig:
    """BASELINE.json's configs[0], mono_tum on TUM fr1_desk, with ORB-SLAM3's
    Examples/Monocular/TUM1.yaml: 640x480, fx 517.306408, fy 516.469215,
    cx 318.643040, cy 255.313989, 1000 features, scale factor 1.2, 8
    levels, FAST 20/7, no IMU, no vocabulary; cut: dist_params=() (the
    room's renderer has no radtan model). At `scale` x its size (the
    intrinsics scaled with it), with use_of and 256 OF slots (as of_icp)
    when `of`, with use_odom when `odom`."""
    orb = OrbConfig(n_features=1000, scale_factor=1.2, n_levels=8,
                    ini_th_fast=20.0, min_th_fast=7.0,
                    height=int(480 * scale), width=int(640 * scale))
    return SystemConfig(
        fx=517.306408 * scale, fy=516.469215 * scale, cx=318.643040 * scale,
        cy=255.313989 * scale, bf=0.0, sensor="mono", use_of=of,
        use_odom=odom,
        frame=FrameConfig(orb=orb, bf=0.0, n_of_slots=256 if of else 0))


def _spy_k4(keep):
    """Wrap kernels.hamming_best2_many so that it keeps, in `keep`, the
    first launch made inside the monocular initializer ("init") and inside
    a KF's triangulation ("tri") with its inputs and outputs; returns the
    function that restores the originals."""
    launch = kernels.hamming_best2_many
    ctx = [None]
    wrapped = {}
    for name, mod, fn in (("init", MI, "try_monocular_init"),
                          ("tri", LM, "_triangulate_with")):
        orig = getattr(mod, fn)

        def hook(*a, _orig=orig, _name=name, **k):
            ctx[0] = _name
            try:
                return _orig(*a, **k)
            finally:
                ctx[0] = None
        wrapped[(mod, fn)] = orig
        setattr(mod, fn, hook)

    def spy(searches, big, **kw):
        out = launch(searches, big, **kw)
        if ctx[0] is not None and ctx[0] not in keep:
            keep[ctx[0]] = (searches, out)
        return out
    kernels.hamming_best2_many = spy

    def restore():
        kernels.hamming_best2_many = launch
        for (mod, fn), orig in wrapped.items():
            setattr(mod, fn, orig)
    return restore


MONO_K4: dict = {}   # phase_mono's kept K4 launches ("init", "tri")


def time_mono_k4(summary, kept=None):
    """K4 held to plain and timed at the monocular path's two shapes (the
    launches phase_mono kept, or `kept`)."""
    kept = MONO_K4 if kept is None else kept
    for what, label in (("init", "init attempt"),
                        ("tri", "triangulation search")):
        _k4_at_path_shape("mono", label, *kept[what], summary)


def _k4_at_path_shape(tag, what, searches, got, summary):
    """Hold one K4 launch of a path to the plain version (every search
    torch.equal) and time it at that shape: device_ms, ms with the
    launcher, plain_ms and the bound (every input and output byte once;
    the distances of the pairs with both sides valid, which is what these
    inputs need); kept under the kernel's path_shapes."""
    worst = _check_k4(f"{tag} {what}", searches, got)
    n_bytes = sum(dq.shape[0] * 33 + dt.shape[0] * 33 + dq.shape[0] * 12
                  for dq, _, dt, _ in searches)
    pairs = sum(int(vq.sum()) * int(vt.sum())
                for _, vq, _, vt in searches)
    dms = device_ms(lambda reps=1: kernels.hamming_best2_many(
        searches, MA.BIG, reps=reps))
    ms = cuda_ms(lambda: kernels.hamming_best2_many(searches, MA.BIG))
    pms = cuda_ms(lambda: [MA.hamming_best2_plain(*x) for x in searches])
    bms, by = bound_ms(n_bytes, pairs * 8, pairs * 512)
    valid = [(int(vq.sum()), int(vt.sum())) for _, vq, _, vt in searches]
    summary["hamming_best2"].setdefault("path_shapes", []).append(dict(
        path=tag, what=what, searches=len(searches),
        shape=[searches[0][0].shape[0], searches[0][2].shape[0]],
        valid=valid, max_abs_err=float(worst), device_ms=dms, ms=ms,
        plain_ms=pms, bound_ms=bms, bound_by=by))
    print(f"[{tag}] K4 at the {what} shape: {len(searches)} searches "
          f"{searches[0][0].shape[0]} x {searches[0][2].shape[0]} (valid "
          f"{valid}) in one launch, equal to plain (max_abs_err {worst}); "
          f"{dms:.4f} ms on the device, {ms:.4f} ms with its launcher, "
          f"plain {pms:.4f} ms, bound {bms:.5f} ms ({by})")


def _mono_expect(slam):
    """K4 on a monocular path: one launch per init attempt and three per
    KF after the init's two; K2 launched."""
    return {"gated_hamming_search": None,
            "hamming_best2": slam.n_init_attempts
            + 3 * (slam._gen_counter - 2)}


def _mono_report(tag, slam, fps):
    """Print what the monocular phases report: the init (frame, points,
    H or F, attempts), the KFs, the points triangulated per KF, ms a frame
    (median) and ms of the KF frames; gate on the init and on K4's count
    basis (init attempts and KFs)."""
    info = slam.mono_init_info
    if info is None:
        raise AssertionError(f"{tag}: no monocular initialization")
    tri = [int(x) for x in slam.n_triangulated]
    kf_times = sorted(float(x) for x in slam.ms.kf_time[slam.ms.kf_valid])
    kf_frames = {int(round(t * fps)) for t in kf_times}
    ms = slam.ms_per_frame
    kf_ms = [ms[i] for i in sorted(kf_frames) if 0 < i < len(ms)]
    other = [m for i, m in enumerate(ms) if i not in kf_frames and i > 0]
    init_frame = int(round(info["time"] * fps))
    print(f"[{tag}] initialized on frame {init_frame} ({info['attempts']} "
          f"attempts, {info['points']} points, "
          f"{'homography' if info['homography'] else 'fundamental'}); "
          f"{slam._gen_counter} KFs made, {len(kf_times)} live; points "
          f"triangulated per KF {tri}")
    print(f"[{tag}] ms/frame: median {np.median(other):.2f} on frames "
          f"without a KF, KF frames {[round(m, 1) for m in kf_ms]}")
    return init_frame


def phase_mono(summary, n_frames: int = MONO_FRAMES):
    """Monocular at mono_tum's configuration (mono_config) through run_path:
    n_frames of the room at 30 fps, gray only, track_monocular. Gates: those
    of run_path with ATE over the last 3/4 < 6 cm at with_scale=True
    (tests/test_e2e_mono.py:45) and without the RPE gate (the scale is
    free); the init within the first 30 frames; the fused K1 exactly once
    a frame, K3 never, K2 launched, K4 exactly once per init attempt and
    three times per KF after the init's two. The path's first init
    attempt's and first triangulation search's K4 launches are kept in
    MONO_K4 (inputs and outputs) for time_mono_k4 to hold to plain and
    time once nothing else runs on the card."""
    cfg = mono_config()
    keep = {}
    restore = _spy_k4(keep)
    try:
        slam = run_path(
            "mono", cfg, MONO_FPS, summary, _mono_expect,
            render=lambda seq, i, t: seq.frame(t)[0],
            track=lambda slam, i, t, gray: slam.track_monocular(gray, t),
            n_frames=n_frames, ate_gate=0.06, tail=0.75, rpe_gate=None)
    finally:
        restore()
    init_frame = _mono_report("mono", slam, MONO_FPS)
    if init_frame >= 30:
        raise AssertionError(f"mono initialized on frame {init_frame}")
    for what in ("init", "tri"):
        if what not in keep:
            raise AssertionError(f"mono: no K4 launch of the {what} step")
    MONO_K4.update(keep)


def phase_mono_inertial(summary, n_frames: int = MONO_INERTIAL_FRAMES):
    """Mono-inertial at examples/run_euroc.py's --mode mono_imu
    configuration (stereo_inertial_config() with sensor "mono": EuRoC cam0
    752x480, EuRoC's IMU noises, the default init; without radtan) through
    run_path: the room's trajectory at MONO_INERTIAL_SCALE x its amplitude
    (tests/test_e2e_mono_inertial.py excites it at 1.2 x and 10 fps), 200
    Hz IMU samples, 20 fps until the first frame after which VIBA1 has
    run, at most n_frames;
    the first frame through track_monocular, then
    track_monocular_inertial. Gates: those of run_path with the 7-DoF ATE
    over the last 2/5 < 8 cm (tests/test_e2e_mono_inertial.py:55), no RPE
    gate; the IMU initialized scale_free, VIBA1 done with its re-run of
    the initialization, |v| < 3 m/s; the launch counts of phase_mono.
    Prints the trajectory's Sim3 scale against ground truth (no gate)."""
    cfg = dataclasses.replace(stereo_inertial_config(), sensor="mono")
    calls = {"init": [], "reinit": []}

    def instrument(slam):
        # log (scale_free, success) of every initialization and re-run
        imu = slam.imu
        for attr, log in (("try_initialize", calls["init"]),
                          ("reinitialize", calls["reinit"])):
            def wrapped(ms, scale_free=False, _fn=getattr(imu, attr),
                        _log=log):
                out = _fn(ms, scale_free=scale_free)
                _log.append((scale_free, bool(out[1])))
                return out
            setattr(imu, attr, wrapped)

    def render(seq, i, t):
        imu = None if i == 0 else tuple(
            x.cpu().numpy() for x in seq.imu_between(
                (i - 1) / MONO_INERTIAL_FPS, t,
                cfg.imu.max_samples_per_frame))
        return seq.frame(t)[0], imu

    def track(slam, i, t, inputs):
        gray, imu = inputs
        if i == 0:
            slam.track_monocular(gray, t)
        else:
            slam.track_monocular_inertial(gray, *imu, t)

    keep = {}
    restore = _spy_k4(keep)
    try:
        slam = run_path(
            "mono_inertial", cfg, MONO_INERTIAL_FPS, summary, _mono_expect,
            render, track, n_frames, ate_gate=0.08, tail=0.4,
            rpe_gate=None, scale=MONO_INERTIAL_SCALE, init=instrument,
            stop=lambda slam, i: slam.imu.viba1_done)
    finally:
        restore()
    _mono_report("mono_inertial", slam, MONO_INERTIAL_FPS)
    imu = slam.imu
    v = imu.body.v.cpu().numpy()
    print(f"[mono_inertial] {slam.map_stats()}; IMU initialized "
          f"{imu.initialized} at t = {imu.init_time} s (attempts, "
          f"scale_free and success: {calls['init']}), VIBA1 {imu.viba1_done}"
          f" (re-runs of the initialization: {calls['reinit']}), VIBA2 "
          f"{imu.viba2_done}; |v| {np.linalg.norm(v):.3f} m/s; Sim3 scale "
          f"of the trajectory against ground truth {slam.ate['scale']:.4f}; "
          f"frames per imu_mode {slam.imu_modes}; VI accepted on "
          f"{slam.n_vi_accepted} frames")
    if not (imu.initialized and any(sf and ok for sf, ok in calls["init"])):
        raise AssertionError("the IMU did not initialize scale_free")
    if not (imu.viba1_done and calls["reinit"]
            and all(sf for sf, _ in calls["reinit"])):
        raise AssertionError("VIBA1 or its scale_free re-init missing")
    if not (np.all(np.isfinite(v)) and np.linalg.norm(v) < 3.0):
        raise AssertionError(f"velocity {v}")


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
    launches = _settled_launches(slam)
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
    _merge_run("merge", LoopConfig(), voc, summary)


def _merge_run(tag, loop, voc, summary, mesh=None):
    """phase_merge's run and gates with LoopConfig `loop` and the system's
    `mesh`; the launch counts go to `summary` (None: not counted). Returns
    the system."""
    cfg = dataclasses.replace(SystemConfig(), time_recently_lost=0.25,
                              min_kfs_for_new_map=6, loop=loop)
    seq = _room(cfg, RECOVER_FPS)
    slam = SlamSystem(cfg, device="cuda", vocab=voc, mesh=mesh)
    checks, attempts = [], []
    _timed(slam.loop_closer, "_verify", checks)
    _timed(slam, "_reloc_attempt", attempts)
    kernels.reset_launch_counts()
    views = {}      # timestamp -> view time (the ground truth's)
    n_a = 0
    while n_a < 22 or (slam.map_stats()["n_kfs"] < 6 and n_a < 60):
        g, d, _ = seq.frame(n_a / RECOVER_FPS)
        slam.track_rgbd(g, d, n_a / RECOVER_FPS)
        views[n_a / RECOVER_FPS] = n_a / RECOVER_FPS
        n_a += 1
    st = slam.map_stats()
    print(f"[{tag}] phase A, {n_a} frames: {st}")
    if st["n_kfs"] < 6 or st["state"] != "OK":
        raise AssertionError(f"{tag} phase A: {st}")
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
    print(f"[{tag}] after blank frames: {st}")
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
        views[t + i / RECOVER_FPS] = i / RECOVER_FPS
        if lc.n_loops + lc.n_merges > before:
            events.append((i, frame_ms[-1]))
        if events and i >= events[0][0] + 6:
            break
    launches = _settled_launches(slam)
    st = slam.map_stats()
    valid = slam.ms.kf_valid.cpu().numpy()
    share = float((slam.ms.kf_map_id.cpu().numpy()[valid]
                   == int(slam.ms.active_map)).mean())
    print(f"[{tag}] revisit, {len(frame_ms)} frames: {st}, loops "
          f"{lc.n_loops}, merges {lc.n_merges}, {share * 100:.1f}% of the "
          f"valid KFs in the active map")
    gt = []
    for ts, v in sorted(views.items()):
        rot_cw, t_cw = (x.cpu().numpy().astype(np.float64)
                        for x in seq.pose_cw(v))
        twc = np.eye(4)
        twc[:3, :3] = rot_cw.T
        twc[:3, 3] = -rot_cw.T @ t_cw
        gt.append((ts, twc))
    slam.ate = ate_rmse(slam.trajectory, gt)
    print(f"[{tag}] SE3 ATE of the tracked frames against ground truth "
          f"{slam.ate['ate_rmse'] * 100:.3f} cm over "
          f"{slam.ate['n_pairs']} poses")
    print(f"[{tag}] ms of the loop-correcting KF frame(s): "
          f"{[(i, round(ms, 2)) for i, ms in events]}; median frame "
          f"{np.median(frame_ms):.2f} ms")
    # the fused KF step defers loop detection: a candidate that matured at
    # a KF is verified and closed fused_lag processed frames later
    lag = [b - a for a, b in slam.loop_events]
    print(f"[{tag}] (detecting KF's frame, correcting frame) of each loop "
          f"or merge: {slam.loop_events}, {lag} frames apart (fused_lag "
          f"{cfg.fused_lag})")
    if st["state"] != "OK" or not events or not share >= 0.9:
        raise AssertionError(f"{tag} failed: {st}, {len(events)} "
                             f"loop/merge events, KF share {share}")
    if not lag or lag[0] != cfg.fused_lag:
        raise AssertionError(f"{tag}: the first loop or merge landed {lag} "
                             f"frames after its KF, not {cfg.fused_lag}")
    print(f"[{tag}] {len(checks)} loop checks, {len(attempts)} "
          f"relocalization attempts on the path")
    if not checks:
        raise AssertionError(f"{tag} made no loop check")
    if summary is not None:
        _count(summary, tag, launches, n_a + n_blank + len(frame_ms),
               {"hamming_best2": len(checks) + len(attempts),
                "gated_hamming_search": None})
    return slam


MERGE_MESH_RMS = 0.05   # m; an H100 reads 0.040905 m, the same every run


def phase_merge_mesh(summary, voc):
    """The merge path with the global BA landmark-sharded over
    LandMesh(["cuda:0"] * MESH_SHARDS): LoopConfig(run_global_ba=True,
    async_global_ba=True), first without a mesh (not counted), then with
    it. Gates: _merge_run's on the mesh run (its launch counts as merge's),
    the asynchronous global BA stepped on that mesh (`_gba.mesh is mesh`,
    `_gba.i >= 1`), the synchronous sharded global BA run at the merge;
    the SE3 ATE of the tracked frames against ground truth at most 2 cm
    (JAX's tolerance) above the run without a mesh; and the merge's
    sharded global BA on its own input again on one shard: KF positions
    within 1e-3 m (the shards change only the order of the sums); and the
    trajectory within MERGE_MESH_RMS of the run without a mesh (RMS over
    the common stamps). JAX's bound on that, 2 cm
    (tests/test_mesh_system_e2e.py:90), fails in the JAX package as well:
    its sharded step is Gauss-Newton without the single-device step's 1e-3
    diagonal and re-gating, and on a freshly merged map it moves the KFs
    by decimetres more (PERF.md §6). MERGE_MESH_RMS is set from the port's
    own reading on the card, the same in every run.
    Prints ms of the synchronous sharded global BA."""
    loop = LoopConfig(run_global_ba=True, async_global_ba=True)
    single = _merge_run("merge_mesh single", loop, voc, None)
    mesh = LandMesh(["cuda:0"] * MESH_SHARDS)
    gba_ms, gba_io = [], []
    dist = LM.global_ba_step_distributed

    def timed_gba(ms, cfg, mesh_, **k):
        t1 = time.perf_counter()
        out = dist(ms, cfg, mesh_, **k)
        torch.cuda.synchronize()
        gba_ms.append((time.perf_counter() - t1) * 1000.0)
        gba_io.append((ms, cfg, out))
        return out
    LM.global_ba_step_distributed = timed_gba
    try:
        slam = _merge_run("merge_mesh", loop, voc, summary, mesh=mesh)
    finally:
        LM.global_ba_step_distributed = dist
    g = slam._gba
    ta = {round(t, 4): p[:3, 3] for t, p in single.trajectory}
    tb = {round(t, 4): p[:3, 3] for t, p in slam.trajectory}
    common = sorted(set(ta) & set(tb))
    d = np.array([ta[t] - tb[t] for t in common])
    rms = float(np.sqrt((d ** 2).sum(1).mean()))
    print(f"[merge_mesh] ATE {slam.ate['ate_rmse'] * 100:.3f} cm with the "
          f"mesh, {single.ate['ate_rmse'] * 100:.3f} cm without; trajectory "
          f"vs the run without a mesh: {rms * 100:.4f} cm RMS over "
          f"{len(common)} stamps")
    print(f"[merge_mesh] {mesh}: async global BA {g.i} micro-steps "
          f"(active {g.active}), synchronous sharded global BA "
          f"{[round(m, 1) for m in gba_ms]} ms")
    if g.mesh is not mesh or slam.loop_closer.mesh is not mesh:
        raise AssertionError("the mesh did not reach the global BA")
    if g.i < 1 or not gba_ms:
        raise AssertionError("the sharded global BA never ran")
    if not rms < MERGE_MESH_RMS:
        raise AssertionError(f"merge_mesh: {rms} m RMS from the run without "
                             "the mesh")
    if not slam.ate["ate_rmse"] <= single.ate["ate_rmse"] + 0.02:
        raise AssertionError(f"merge_mesh: ATE {slam.ate['ate_rmse']} m "
                             f"against {single.ate['ate_rmse']} m without "
                             "the mesh")
    ms, cfg, out = gba_io[0]
    one = dist(ms, cfg, LandMesh(["cuda:0"]))
    v = ms.kf_valid & (ms.kf_map_id == ms.active_map)

    def centres(m):
        return -(m.kf_rot[v].transpose(1, 2) @ m.kf_t[v][:, :, None])[..., 0]
    gap = float((centres(out) - centres(one)).norm(dim=1).max())
    moved = float((centres(out) - centres(ms)).norm(dim=1).max())
    print(f"[merge_mesh] the merge's sharded global BA moved {int(v.sum())} "
          f"KFs by up to {moved * 100:.3f} cm; {MESH_SHARDS} shards vs 1 on "
          f"its input: {gap:.3e} m")
    if not gap < 1e-3:
        raise AssertionError(f"merge_mesh: {MESH_SHARDS} shards part from 1 "
                             f"by {gap} m")


def phase_mesh_gba(summary):
    """The landmark-sharded global BA at production shapes
    (tools/dryrun_multichip.py: 256 KFs x 512 observations of 4096
    landmarks, the JAX dry run's landmark draw, m_max 16384, ba_pts 4096)
    with four shards on the card.
    Gates: the median landmark error after 2 iterations under 2 cm (the
    JAX dry run's gate) and within 5e-5 m of the JAX dry run's own reading
    on the CPU (dryrun_multichip.REFERENCE_MEDIAN_ERR); KF translations within 1e-4 m of the 1-shard
    mesh's after 5 iterations (tests/test_parallel.py:68); no hand-written
    kernel launched (the products are torch.einsum calls, as the JAX
    package's are plain XLA). Prints, for mesh sizes 1 and 4, ms per
    iteration (CUDA events around 5 calls of one iteration after a warm-up)
    and the bytes of the partial reduced systems summed per iteration."""
    from geoflowslam_tpu_torch.tools import dryrun_multichip as DR
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ms, pts = DR.populated_map("cuda", pts=DR.reference_landmarks())
    torch.cuda.synchronize()
    print(f"[mesh_gba] production map built in "
          f"{time.perf_counter() - t0:.2f} s")
    meshes = {n: DR.mesh_of(n, ["cuda:0"]) for n in (1, MESH_SHARDS)}
    err = DR.check_gate(ms, pts, meshes[MESH_SHARDS],
                        reference=DR.REFERENCE_MEDIAN_ERR)
    prob = DR.gba_problem(ms)
    c = MappingConfig()
    outs = {n: dist_ba.make_distributed_ba(m, c.fx, c.fy, c.cx, c.cy, c.bf,
                                           iters=5)(prob)
            for n, m in meshes.items()}
    valid = prob.kf_valid
    dkf = float((outs[1].kf_t - outs[MESH_SHARDS].kf_t)[valid].abs().max())
    dpt = float((outs[1].pts - outs[MESH_SHARDS].pts).abs().max())
    print(f"[mesh_gba] median landmark error after 2 iterations "
          f"{err * 100:.6f} cm (the JAX dry run's "
          f"{DR.REFERENCE_MEDIAN_ERR * 100:.6f} cm); after 5: KF translations "
          f"{MESH_SHARDS} vs 1 shard within {dkf:.3e} m, points {dpt:.3e} m")
    for n, mesh in meshes.items():
        ms_it = DR.time_iteration(prob, mesh, reps=5)
        nb = dist_ba.reduced_bytes(int(prob.kf_rot.shape[0]), mesh)
        print(f"[mesh_gba] mesh {n} ({mesh}): {ms_it:.3f} ms/iter, "
              f"{nb} B of partial reduced systems summed/iter")
    if not dkf < 1e-4:
        raise AssertionError(f"mesh_gba: {MESH_SHARDS} shards part from 1 "
                             f"by {dkf} m")
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    if launches:
        raise AssertionError(f"mesh_gba launched kernels: {launches}")


def _mono_geoflow_expect(slam):
    """mono's counts, and the fused K3 once a frame after the init."""
    init = int(round(slam.mono_init_info["time"] * MONO_FPS))
    return {**_mono_expect(slam), "lk_pyramid": slam.n_frames - init - 1}


# m: the JAX package's SlamSystem on mono_geoflow_config() over the same
# sequence (120 frames) reads a 7-DoF ATE of 0.061818 m on the CPU; 5 mm
# on top.
MONO_GEOFLOW_ATE = 0.06182 + 0.005


def mono_geoflow_config(scale: float = 1.0) -> SystemConfig:
    """mono_config() with use_of (256 OF slots, as of_icp) and use_odom; at
    `scale` x its 640x480 (intrinsics scaled with it)."""
    return mono_config(scale, of=True, odom=True)


def _mono_geoflow_track(slam, i, t, gray):
    """Queue the trajectory's world velocity (the renderer's body velocity,
    as g1 queues it), then track the frame."""
    slam.set_odom(smooth_trajectory(torch.tensor(t))[2].numpy(),
                  odom_frame=False)
    slam.track_monocular(gray, t)


def phase_mono_geoflow(summary, n_frames: int = MONO_FRAMES):
    """Monocular with GeoFlow's optical flow and odometry:
    mono_geoflow_config(), n_frames of the room at 30 fps through run_path,
    the trajectory's world velocity queued before every frame. Gates: those
    of phase_mono (state OK, >= 3 KFs, the init within 30 frames, K1 once a
    frame, K2 launched, K4 once per init attempt and three times per KF
    after the init's two), the fused K3 once a frame after the init, OF
    points appended, the odometry queue read and emptied on every frame
    after the init, and the 7-DoF ATE over the last 3/4 under
    MONO_GEOFLOW_ATE: the JAX package's own reading on this configuration
    and sequence (0.06182 m, over test_e2e_mono.py's 6 cm: the OF
    slots lift this scene's ATE at 640x480 in both packages; PERF.md §6)
    plus 5 mm, five times the packages' gap at 320x240."""
    slam = run_path(
        "mono_geoflow", mono_geoflow_config(), MONO_FPS, summary,
        _mono_geoflow_expect, render=lambda seq, i, t: seq.frame(t)[0],
        track=_mono_geoflow_track, n_frames=n_frames,
        ate_gate=MONO_GEOFLOW_ATE, tail=0.75, rpe_gate=None)
    init_frame = _mono_report("mono_geoflow", slam, MONO_FPS)
    n3d, n2d = slam.of_appended
    after = n_frames - init_frame - 1
    print(f"[mono_geoflow] OF appended {n3d} 3D-stream and {n2d} 2D-stream "
          f"points; odometry read on {slam.n_odom_frames} of {after} frames "
          f"after the init, {len(slam._odom_queue)} samples left")
    if init_frame >= 30:
        raise AssertionError(f"mono_geoflow initialized on frame "
                             f"{init_frame}")
    if n3d + n2d <= 0:
        raise AssertionError("the optical-flow stage appended no point")
    if slam.n_odom_frames != after or slam._odom_queue:
        raise AssertionError("the odometry queue was not read every frame")


def phase_quickstart(summary):
    """README's first commands: tools/run_synthetic.main --mode
    rgbd_inertial --frames QUICK_FRAMES (640x480, 30 fps) on the card, then
    tools/evaluate_ate.main on its CameraTrajectory.txt against a ground
    truth written from the sequence. Gates: OK, the shutdown file set,
    run_synthetic's ATE < 5 cm, evaluate_ate's ATE within 1e-5 m of it
    (the TUM file's text rounding) over every recorded pose; the
    fused K1 once a frame, K2 launched, K4 never (no vocabulary)."""
    import os
    import tempfile
    from geoflowslam_tpu_torch.io.trajectory import save_trajectory_tum
    from geoflowslam_tpu_torch.tools import evaluate_ate, run_synthetic
    out = tempfile.mkdtemp(prefix="quickstart_")
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_synthetic.main(["--mode", "rgbd_inertial", "--frames",
                                  str(QUICK_FRAMES), "--out", out])
        launches = dict(kernels.launch_counts)
        wall = time.perf_counter() - t0
        seq = _room(dataclasses.replace(
            SystemConfig(), fx=400.0, fy=400.0, cx=320.0, cy=240.0), 30.0)
        gt = []
        for i in range(QUICK_FRAMES):
            rot_cw, t_cw = (x.cpu().numpy().astype(np.float64)
                            for x in seq.pose_cw(i / 30.0))
            twc = np.eye(4)
            twc[:3, :3] = rot_cw.T
            twc[:3, 3] = -rot_cw.T @ t_cw
            gt.append((i / 30.0, twc))
        gt_path = os.path.join(out, "groundtruth.txt")
        save_trajectory_tum(gt_path, gt)
        ev = evaluate_ate.main([os.path.join(out, "CameraTrajectory.txt"),
                                gt_path])
        files = sorted(os.listdir(out))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ate = res["ate"]["ate_rmse"]
    print(f"[quickstart] run_synthetic rgbd_inertial {QUICK_FRAMES} frames "
          f"in {wall:.1f} s: {res['stats']}, ATE {ate * 100:.3f} cm; "
          f"evaluate_ate {ev['ate_rmse'] * 100:.3f} cm over "
          f"{ev['n_pairs']} pairs; files {files}")
    if res["stats"]["state"] != "OK" or not ate < 0.05:
        raise AssertionError(f"quickstart: {res['stats']}, ATE {ate}")
    n_poses = len(res["slam"].trajectory)
    if abs(ev["ate_rmse"] - ate) > 1e-5 or ev["n_pairs"] != n_poses:
        raise AssertionError(f"evaluate_ate read {ev} against {ate}")
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt",
                 "map.html"):
        if name not in files:
            raise AssertionError(f"run_synthetic wrote no {name}")
    _count(summary, "quickstart", launches, QUICK_FRAMES,
           {"gated_hamming_search": None})


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
    split = SyncSplit(slam)
    kernels.reset_launch_counts()
    gt, ms_per_frame = [], []
    for i in range(HARD_FRAMES):
        t_abs = 1.4e9 + ts[i]
        split.active = HARD_SYNC[0] <= i < HARD_SYNC[1]
        t1 = time.perf_counter()
        slam.track_rgbd(bufs[i], None, t_abs)
        torch.cuda.synchronize()
        if not split.active:
            ms_per_frame.append((time.perf_counter() - t1) * 1000.0)
        gt.append((t_abs, twc_gt[i]))
    launches = _settled_launches(slam)
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
    print(f"[hard] ms/frame (frames 2..{HARD_FRAMES} but the counted "
          f"ones): median "
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
    split.report("hard", HARD_SYNC[0], HARD_SYNC[1] - 1)


def inertial_config() -> SystemConfig:
    """bench.py's operating point (bench.py:80-106) on the port: 640x480,
    fx 400, bf 40, the m12 feed, 1000 features, 8 levels, lk_levels 4,
    cloud_stride 4, 4096 cloud points, k_max 256, m_max 65536, an IMU
    initialized early (init_min_kfs 4, init_min_time 0.8 s), LoopConfig()."""
    orb = OrbConfig(n_features=1000, n_levels=8, height=480, width=640)
    fc = FrameConfig(orb=orb, lk_levels=4, cloud_stride=4, cloud_max_pts=4096,
                     depth_map_factor=1.0, feed_codec="m12")
    return SystemConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0, bf=40.0,
                        frame=fc, imu=ImuConfig(init_min_kfs=4,
                                                init_min_time=0.8),
                        loop=LoopConfig())


def _count_syncs(fn, sites=None):
    """Run fn() with CUDA sync debugging on; returns (its result, the
    number of synchronizing calls it made). With a list `sites`, the
    innermost frame of the port's package (file:line) of each call is
    appended to it."""
    import traceback
    import warnings
    n = [0]

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        n[0] += 1
        if sites is not None:
            frames = [f for f in traceback.extract_stack()
                      if "geoflowslam_tpu_torch" in f.filename]
            f = frames[-1] if frames else None
            sites.append("geoflowslam_tpu_torch"
                         f"{f.filename.split('geoflowslam_tpu_torch')[-1]}"
                         f":{f.lineno}" if f else f"{filename}:{lineno}")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, n[0]


def _settled_launches(slam):
    """The launch counts once every deferred KF result of `slam` is applied
    (map_stats drains them: a matured loop check launches K4 and K2)."""
    slam.map_stats()
    return dict(kernels.launch_counts)


SYNCS_BEFORE = {"rgbd": 3.0, "of_icp": 3.0, "g1": 3.0, "hard": 3.0,
                "inertial": 34.97, "inertial_geoflow": 55.13}
# host syncs a frame before the fused frame step (PERF.md §5: RGB-D 3 a
# frame by count, the inertial paths measured with CUDA sync debugging)
MAX_FUSED_SYNCS = 1.0   # gate: host syncs a fused frame without a KF
MAX_FUSED_KF_SYNCS = 2.0   # gate: host syncs a fused KF frame (the mirror
                           # clean, no loop candidate matured), pooled over
MIN_FUSED_KF_FRAMES = 8    # at least this many of the sync windows' frames
FUSED_KF_SYNCS: list = []  # (path, syncs) of each such frame, this process
FUSED_KF_SITES: dict = {}  # file:line -> syncs at it on those frames


class SyncSplit:
    """Host syncs inside the system's RGB-D entry points (CUDA sync
    debugging) while `active`, kept apart for the frames that went through
    the fused frame step without a KF, the fused KF frames (a KF through
    the fused KF step, the mirror clean and no loop candidate matured:
    their syncs go to FUSED_KF_SYNCS, and their sites to FUSED_KF_SITES),
    the frames where a loop candidate matured or the slot mirror resynced,
    the frames whose KF took the staged KF step (with use_lidar a tracked
    fused frame's KF does), and the others (staged, initialization). Wraps
    the instance's entry points, its fused step and its staged KF step;
    the calling loop's own reads between frames are not counted."""

    KINDS = ("fused", "kf_fused", "kf_event", "kf_staged", "other")

    def __init__(self, slam):
        self.slam, self.active = slam, False
        self.fused = self.staged_kf = False
        self.counts = {k: [] for k in self.KINDS}
        track_fused = slam._track_fused
        staged_kf = slam._insert_keyframe_staged

        def flagged(*a, **k):
            self.fused = True
            return track_fused(*a, **k)

        def flagged_kf(*a, **k):
            self.staged_kf = True
            return staged_kf(*a, **k)
        slam._track_fused = flagged
        slam._insert_keyframe_staged = flagged_kf
        for name in ("track_rgbd", "track_rgbd_inertial"):
            setattr(slam, name, self._counted(getattr(slam, name)))

    def _counted(self, entry):
        def counted(*a, **k):
            if not self.active:
                return entry(*a, **k)
            self.fused = self.staged_kf = False
            s = self.slam
            before = (s._gen_counter, s.n_mirror_syncs, s.n_loop_matured)
            sites = []
            out, n = _count_syncs(lambda: entry(*a, **k), sites)
            kf = s._gen_counter != before[0]
            if (s.n_mirror_syncs, s.n_loop_matured) != before[1:]:
                kind = "kf_event"
            elif kf:
                kind = ("kf_fused" if self.fused and not self.staged_kf
                        else "kf_staged")
            else:
                kind = "fused" if self.fused else "other"
            self.counts[kind].append(n)
            if kind == "kf_fused":
                FUSED_KF_SYNCS.append(n)
                for site in sites:
                    FUSED_KF_SITES[site] = FUSED_KF_SITES.get(site, 0) + 1
            return out
        return counted

    def report(self, tag, first, last):
        """Print the split and gate the fused frames without a KF (at most
        MAX_FUSED_SYNCS a frame on average, over at least 10 of them); the
        fused KF frames are gated pooled over the paths (gate_fused_kf)."""
        mean = {k: (float(np.mean(v)) if v else float("nan"), len(v))
                for k, v in self.counts.items()}
        print(f"[{tag}] host syncs a frame over frames {first}..{last}: "
              f"fused without a KF {mean['fused'][0]:.2f} "
              f"({mean['fused'][1]} frames), fused KF frames "
              f"{mean['kf_fused'][0]:.2f} ({mean['kf_fused'][1]}), a loop "
              f"matured or the mirror resynced {mean['kf_event'][0]:.2f} "
              f"({mean['kf_event'][1]}), staged KF frames "
              f"{mean['kf_staged'][0]:.2f} ({mean['kf_staged'][1]}), other "
              f"{mean['other'][0]:.2f} ({mean['other'][1]}); "
              f"{SYNCS_BEFORE[tag]:.2f} a frame before the fused step")
        if mean["fused"][1] < 10 or not mean["fused"][0] <= MAX_FUSED_SYNCS:
            raise AssertionError(
                f"{tag}: {mean['fused'][0]} host syncs a fused frame without "
                f"a KF over {mean['fused'][1]} frames (gate "
                f"{MAX_FUSED_SYNCS} over >= 10)")
        return mean


def gate_fused_kf(syncs, sites):
    """Gate the fused KF frames of every sync window pooled: at most
    MAX_FUSED_KF_SYNCS host syncs a frame on average over at least
    MIN_FUSED_KF_FRAMES frames; print the sites of the syncs left."""
    mean = float(np.mean(syncs)) if syncs else float("nan")
    print(f"[syncs] fused KF frames of the sync windows: {mean:.2f} host "
          f"syncs a frame over {len(syncs)} frames (72-82 when the mapping "
          f"step read the device); sites "
          f"{dict(sorted(sites.items(), key=lambda x: -x[1]))}")
    if len(syncs) < MIN_FUSED_KF_FRAMES or not mean <= MAX_FUSED_KF_SYNCS:
        raise AssertionError(
            f"{mean} host syncs a fused KF frame over {len(syncs)} frames "
            f"(gate {MAX_FUSED_KF_SYNCS} over >= {MIN_FUSED_KF_FRAMES})")


def _drive_inertial(tag, cfg, voc, n_frames, sync=SYNC_WINDOW, viba2=True,
                    session=None):
    """Drive SlamSystem.track_rgbd_inertial over n_frames of the synthetic
    room's smooth trajectory at 30 fps with 200 Hz IMU samples (at most 32
    a frame) on m12 buffers pre-packed on the card, with `voc`; time every
    frame (but those of the `sync` window, whose host syncs are counted
    with CUDA sync debugging) and every VI-BA, count the loop checks and
    relocalization attempts, print what the inertial phases report, gate
    on the IMU initialization and VIBA1 (and VIBA2 with `viba2`), and
    return (slam, launches, K4 launches expected). With `session` (a dict
    with "at" and "path"), save_session is called before frame
    session["at"] (timed), and the dict gets what _check_session needs:
    the frames, their IMU samples and times, the map counts at the save,
    and the unbroken run's position after every later frame."""
    dev = torch.device("cuda")
    seq = _room(cfg, FPS)
    ts = np.arange(n_frames) / FPS
    t0 = time.perf_counter()
    bufs, imu, gt = [], [None], []
    for i in range(n_frames):
        g, d, (rot_cw, t_cw) = seq.frame(ts[i])
        bufs.append(FC.pack_m12_torch(g, d))
        if i > 0:
            imu.append(tuple(x.cpu().numpy() for x in seq.imu_between(
                ts[i - 1], ts[i], cfg.imu.max_samples_per_frame)))
        r = rot_cw.cpu().numpy().astype(np.float64)
        twc = np.eye(4)
        twc[:3, :3] = r.T
        twc[:3, 3] = -r.T @ t_cw.cpu().numpy()
        gt.append((ts[i], twc))
    bufs = [b.cpu().numpy() for b in bufs]
    print(f"[{tag}] pre-rendered {n_frames} m12 frames 640x480 and their "
          f"IMU samples in {time.perf_counter() - t0:.2f} s")
    slam = SlamSystem(cfg, dev, vocab=voc)
    checks, attempts, viba = [], [], []
    _timed(slam.loop_closer, "_verify", checks)
    _timed(slam, "_reloc_attempt", attempts)
    vi_ba_step = LM.vi_ba_step

    def timed_vi_ba(ms, win, mcfg):
        t1 = time.perf_counter()
        out = vi_ba_step(ms, win, mcfg)
        torch.cuda.synchronize()
        viba.append((win.slots.shape[0], (time.perf_counter() - t1) * 1e3))
        return out
    LM.vi_ba_step = timed_vi_ba
    kernels.reset_launch_counts()
    by_mode, split = {}, SyncSplit(slam)
    try:
        for i in range(n_frames):
            if session is not None and i == session["at"]:
                t1 = time.perf_counter()
                slam.save_session(session["path"])
                session.update(save_s=time.perf_counter() - t1,
                               saved=slam.map_stats(), positions=[],
                               frames=(bufs, imu, ts))
            before = dict(slam.imu_modes)

            def step():
                if i == 0:
                    return slam.track_rgbd(bufs[i], None, ts[i])
                return slam.track_rgbd_inertial(bufs[i], None, *imu[i],
                                                ts[i])
            t1 = time.perf_counter()
            split.active = sync[0] <= i < sync[1]
            step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1000.0
            mode = next((m for m, n in slam.imu_modes.items()
                         if n != before.get(m, 0)), "init")
            if not sync[0] <= i < sync[1]:
                by_mode.setdefault(mode, []).append(ms)
            if session is not None and i >= session["at"]:
                session["positions"].append(slam.current_pose_wc()[:3, 3])
    finally:
        LM.vi_ba_step = vi_ba_step
    launches = _settled_launches(slam)
    stats = slam.map_stats()
    traj = slam.trajectory
    poses = np.stack([p for _, p in traj])
    half = n_frames // 2
    ate = ate_rmse([e for e in traj if e[0] >= ts[half]], gt[half:])
    imu_t = slam.imu
    v = imu_t.body.v.cpu().numpy()
    n_vi = sum(n for m, n in slam.imu_modes.items() if m in ("kf", "prior"))
    print(f"[{tag}] {stats}, {len(traj)} poses, ATE over the second half "
          f"{ate['ate_rmse'] * 100:.3f} cm; IMU initialized "
          f"{imu_t.initialized} at t = {imu_t.init_time} s, VIBA1 "
          f"{imu_t.viba1_done}, VIBA2 {imu_t.viba2_done}; |v| "
          f"{np.linalg.norm(v):.3f} m/s; n_lost {slam.n_lost}")
    print(f"[{tag}] frames per imu_mode {slam.imu_modes}; VI accepted "
          f"on {slam.n_vi_accepted} of {n_vi} VI frames")
    for mode, v_ms in sorted(by_mode.items()):
        print(f"[{tag}] ms/frame in mode {mode}: median "
              f"{np.median(v_ms):.2f}, p90 {np.percentile(v_ms, 90):.2f} "
              f"over {len(v_ms)} frames")
    for kw in sorted({k for k, _ in viba}):
        v_kw = [m for k, m in viba if k == kw]
        print(f"[{tag}] VI-BA kw {kw}: {len(v_kw)} runs, median "
              f"{np.median(v_kw):.2f} ms, max {np.max(v_kw):.2f} ms")
    print(f"[{tag}] {len(checks)} loop checks, {len(attempts)} "
          f"relocalization attempts")
    split.report(tag, sync[0], sync[1] - 1)
    if stats["state"] != "OK" or stats["n_maps"] != 1:
        raise AssertionError(f"{tag} path ended {stats}")
    if not (imu_t.initialized and imu_t.viba1_done
            and (imu_t.viba2_done or not viba2)):
        raise AssertionError("IMU initialization or VIBA1/VIBA2 missing")
    if not np.all(np.isfinite(poses)) or poses.shape[1:] != (4, 4):
        raise AssertionError("non-finite or misshapen poses")
    if not ate["ate_rmse"] < 0.05:
        raise AssertionError(f"{tag} ATE {ate['ate_rmse']} m >= 5 cm")
    return slam, launches, len(checks) + len(attempts)


FUSED_FRAMES = 50   # the fused_step phase's map: 1.7 s at 30 fps (the IMU
                    # initializes at ~1.1 s)
FUSED_TURN = 0.6    # rad of yaw added to the recovery variant's prediction


def fused_step_config() -> SystemConfig:
    """inertial_config() (bench.py's operating point) with use_icp and
    use_lidar and 256 reserved OF slots, the OF stage itself off, so that
    one map, tracked by its ORB features, serves every variant of the frame
    step (the OF variants append into the reserved slots)."""
    base = inertial_config()
    return dataclasses.replace(
        base, use_icp=True, use_lidar=True,
        frame=dataclasses.replace(base.frame, n_of_slots=256,
                                  lidar_features=True))


def _fused_call(args, kw, allowed: int):
    """One frame_step call under CUDA sync debugging ("error" when no sync
    is allowed, else "warn" and counted): (out, host ms, device ms between
    CUDA events around the call, syncs)."""
    import warnings
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("error" if allowed == 0 else "warn")
        try:
            t0 = time.perf_counter()
            e0.record()
            out = FU.frame_step(*args, **kw)
            e1.record()
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    e1.synchronize()
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, host_ms, e0.elapsed_time(e1), n


def phase_fused_step(summary, voc):
    """pipeline/fused.frame_step on the card at full width: a map built by
    tracking FUSED_FRAMES frames of the synthetic room at 30 fps with 200 Hz
    IMU through SlamSystem.track_rgbd_inertial at fused_step_config() (m12
    buffers on the card, the shipped vocabulary, ICP and lidar on, 256 OF
    slots reserved), then the next frame
    through frame_step directly from the system's state in seven variants:
    off, raw, kf, prior (under the kf variant's marginal), OF+ICP, OF+ICP+
    lidar with kf, and recovery (visual, the motion model turned by
    FUSED_TURN rad so that the track fails: the re-search and the
    relocalization run). Each variant runs once to warm the per-device
    caches and once measured, under torch.cuda.set_sync_debug_mode("error")
    (the recovery variant under "warn", counted). Gates: no synchronizing
    call (at most 1 in the recovery variant), a finite packet, every
    tracked variant OK with aux 0, the VI accepted in kf and prior, the
    recovery variant recovered (aux >= 2), the kf and OF+ICP+lidar poses
    within 2 cm and 1 deg of the façade's own fused step on that frame;
    the map's frames launch the fused K1 once a frame, K2, K4 once per
    loop check and relocalization attempt, and K3 never (their OF stage is
    off). Prints host ms and device ms of each measured call."""
    dev = torch.device("cuda")
    cfg = fused_step_config()
    seq = _room(cfg, FPS)
    n = FUSED_FRAMES
    ts = np.arange(n + 1) / FPS
    bufs, imu = [], [None]
    for i in range(n + 1):
        g, d, _ = seq.frame(ts[i])
        bufs.append(FC.pack_m12_torch(g, d))
        if i > 0:
            imu.append(tuple(x.cpu().numpy() for x in seq.imu_between(
                ts[i - 1], ts[i], cfg.imu.max_samples_per_frame)))
    slam = SlamSystem(cfg, dev, vocab=voc)
    checks, attempts = [], []
    _timed(slam.loop_closer, "_verify", checks)
    _timed(slam, "_reloc_attempt", attempts)
    kernels.reset_launch_counts()
    for i in range(n):
        if i == 0:
            slam.track_rgbd(bufs[i], None, ts[i])
        else:
            slam.track_rgbd_inertial(bufs[i], None, *imu[i], ts[i])
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    stats = slam.map_stats()
    print(f"[fused_step] map of {n} frames: {stats}, IMU initialized "
          f"{slam.imu.initialized}, frames per imu_mode {slam.imu_modes}")
    if stats["state"] != "OK" or not slam.imu.initialized:
        raise AssertionError(f"fused_step map: {stats}")
    _count(summary, "fused_step", launches, n,
           {"gated_hamming_search": None,
            "hamming_best2": len(checks) + len(attempts)})
    del slam._reloc_attempt    # the timing wrapper synchronises

    # the next frame's inputs, as the façade stages them
    images = (bufs[n], None)
    p_host = PRE.preintegrate(*(PRE.host_f32(x) for x in imu[n]),
                              slam.imu.bias, slam.imu.calib)
    p_frame = PRE.to_device(p_host, dev)
    off = dict(use_of=False, use_icp=False, use_lidar=False)
    geo = dict(use_of=True, use_icp=True, use_lidar=False)
    full = dict(use_of=True, use_icp=True, use_lidar=True)
    turn = lie.so3_exp(torch.tensor([0.0, FUSED_TURN, 0.0], device=dev))
    results = {}
    for name, mode, flags, recovery in (
            ("off", "off", off, False), ("raw", "raw", off, False),
            ("kf", "kf", off, False), ("prior", "prior", off, False),
            ("of_icp", "off", geo, False),
            ("of_icp_lidar_kf", "kf", full, False),
            ("recovery", "off", off, True)):
        if name == "prior":
            slam._vi_prior = results["kf"][0].marg
        args, kw = slam._fused_inputs(
            images, mode, None if mode == "off" else p_frame, recovery)
        kw.update(flags)
        if recovery:
            args = list(args)
            args[5] = turn @ args[5]          # vel_rot: a wrong prediction
            args[7] = True                    # use_vel
        for _ in range(2):
            out, host_ms, dev_ms, n_sync = _fused_call(
                args, kw, 1 if recovery else 0)
        pkt = out.host_pkt.cpu().numpy()
        results[name] = (out, pkt)
        print(f"[fused_step] {name}: host {host_ms:.2f} ms, device "
              f"{dev_ms:.2f} ms (CUDA events around the call), "
              f"{n_sync} synchronizing calls; n_mm {pkt[0]:.0f}, n_lm "
              f"{pkt[1]:.0f}, n_vi {pkt[2]:.0f}, vi_ok {pkt[3]:.0f}, aux "
              f"{pkt[FU.PKT_AUX]:.0f}, relocalized {pkt[FU.PKT_RELOC]:.0f}")
        if not np.all(np.isfinite(pkt)) or n_sync > (1 if recovery else 0):
            raise AssertionError(f"fused_step {name}: {n_sync} syncs, "
                                 f"packet {pkt}")
        tracked = max(pkt[1], pkt[2] if pkt[3] > 0.5 else -1)
        if recovery:
            if pkt[FU.PKT_AUX] < 2.0:
                raise AssertionError(f"fused_step recovery did not recover: "
                                     f"{pkt}")
        elif tracked < cfg.min_inliers_ok or pkt[FU.PKT_AUX] != 0.0:
            raise AssertionError(f"fused_step {name} did not track: {pkt}")
        if mode in ("kf", "prior") and pkt[3] < 0.5:
            raise AssertionError(f"fused_step {name}: VI not accepted")
    slam._vi_prior = None
    twc = slam.track_rgbd_inertial(bufs[n], None, *imu[n], ts[n])
    for name in ("kf", "of_icp_lidar_kf"):
        m = results[name][1][4:16].reshape(3, 4)
        gap = float(np.linalg.norm(m[:, 3] - twc[:3, 3]))
        ang = float(np.degrees(np.arccos(np.clip(
            (np.trace(m[:, :3].T @ twc[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))))
        print(f"[fused_step] {name} against the façade's step on the frame: "
              f"{gap * 100:.3f} cm, {ang:.4f} deg")
        if gap > 0.02 or ang > 1.0:
            raise AssertionError(f"fused_step {name} {gap} m, {ang} deg from "
                                 "the façade's")


def phase_inertial(summary, voc, n_frames: int = INERTIAL_FRAMES):
    """The RGB-D-inertial path at bench.py's configuration
    (inertial_config) through _drive_inertial, the shipped vocabulary, loop
    closing on. Gates: state OK with 1 map, the IMU initialized, VIBA1 and
    VIBA2 done, ATE over the second half < 5 cm, the final velocity finite
    and < 3 m/s, the fused K1 once per frame, K2 launched, K4 exactly once
    per loop check and relocalization attempt. Prints the frames and ms per
    imu_mode (median, p90), the VI accepted share, VI-BA ms per KF by window
    width, and the host syncs a frame over SYNC_WINDOW (CUDA sync
    debugging; those frames are left out of the times)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")
    session = dict(at=min(SESSION_AT, n_frames - 1),
                   path=f"{tmp}/session")
    slam, launches, n_k4 = _drive_inertial("inertial", inertial_config(),
                                           voc, n_frames, session=session)
    v = slam.imu.body.v.cpu().numpy()
    if not (np.all(np.isfinite(v)) and np.linalg.norm(v) < 3.0):
        raise AssertionError(f"velocity {v}")
    _count(summary, "inertial", launches, n_frames,
           {"gated_hamming_search": None, "hamming_best2": n_k4})
    try:
        _check_session("inertial", slam, voc, session)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_session(tag, slam, voc, session):
    """The session checkpoint at bench.py's capacities: a fresh SlamSystem
    with the same config and vocabulary loads the file written at frame
    session["at"] and drives the same frames to the end again. Gates, the
    JAX package's (tests/test_persistence.py:98-110): the restored KF and
    map-point counts equal to the saved ones, state OK and the IMU
    initialized after the load, the final position within 5 cm of the
    unbroken run's, the KF counts at the end within 2. Prints the file's
    size, the save and load seconds and the largest per-frame position
    gap."""
    import os
    bufs, imu, ts = session["frames"]
    path = session["path"] + ".npz"
    mb = os.path.getsize(path) / 2 ** 20
    fresh = SlamSystem(slam.cfg, torch.device("cuda"), vocab=voc)
    t1 = time.perf_counter()
    fresh.load_session(session["path"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    restored = fresh.map_stats()
    if (restored["n_kfs"], restored["n_mps"]) != (
            session["saved"]["n_kfs"], session["saved"]["n_mps"]):
        raise AssertionError(f"{tag} restored {restored}, saved "
                             f"{session['saved']}")
    if restored["state"] != "OK" or not fresh.imu.initialized:
        raise AssertionError(f"{tag} restored state {restored['state']}, "
                             f"IMU initialized {fresh.imu.initialized}")
    gaps = []
    for k, i in enumerate(range(session["at"], len(bufs))):
        fresh.track_rgbd_inertial(bufs[i], None, *imu[i], ts[i])
        gaps.append(float(np.linalg.norm(
            fresh.current_pose_wc()[:3, 3] - session["positions"][k])))
    end_a, end_b = slam.map_stats(), fresh.map_stats()
    print(f"[{tag}] session at frame {session['at']} (k_max "
          f"{slam.cfg.k_max}, m_max {slam.cfg.m_max}): {mb:.2f} MB, save "
          f"{session['save_s']:.3f} s, load {load_s:.3f} s; restored "
          f"{restored}; after {len(gaps)} frames again {end_b} (unbroken "
          f"{end_a}); position gap max {max(gaps) * 100:.3f} cm, final "
          f"{gaps[-1] * 100:.3f} cm")
    if end_b["state"] != "OK" or not gaps[-1] < 0.05:
        raise AssertionError(f"{tag} restored run ended {end_b}, "
                             f"{gaps[-1]} m from the unbroken run")
    if abs(end_a["n_kfs"] - end_b["n_kfs"]) > 2:
        raise AssertionError(f"{tag} KF counts {end_a} vs {end_b}")


def phase_inertial_geoflow(summary, voc,
                           n_frames: int = INERTIAL_GEOFLOW_FRAMES):
    """bench.py's operating point with GeoFlow's streams on:
    inertial_config() with use_icp, use_of and n_of_slots 256, through
    _drive_inertial over INERTIAL_GEOFLOW_FRAMES frames. Gates: those of
    the inertial phase
    but VIBA2 (VIBA1 only), >= 1 accepted ICP prediction, >= 1 EdgeICP row
    with an inter-KF measurement in a VI-BA window, optical-flow points
    appended, the fused K3 once per frame after the first, and the EdgeICP
    factor on the card (_check_edge_icp on the latest of the path's last
    four VI-BA problems that has a measurement). Prints the inter-KF
    registrations and how many passed their gate (its `error < 0.01` is
    the reference's mean point distance, which a 5 cm voxel cloud of the
    room does not reach)."""
    base = inertial_config()
    cfg = dataclasses.replace(
        base, use_icp=True, use_of=True,
        frame=dataclasses.replace(base.frame, n_of_slots=256))
    vi_local_ba, kept = VIBA.vi_local_ba, []

    def keep_problem(prob, *a, **k):
        # the last few VI-BA problems with EdgeICP rows (read after the run:
        # no host sync here)
        if prob.icp is not None:
            kept[:] = kept[-3:] + [(prob, a)]
        return vi_local_ba(prob, *a, **k)
    VIBA.vi_local_ba = keep_problem
    try:
        slam, launches, n_k4 = _drive_inertial(
            "inertial_geoflow", cfg, voc, n_frames, GEOFLOW_SYNC, viba2=False)
    finally:
        VIBA.vi_local_ba = vi_local_ba
    gates = [bool(rel[3]) for rel in slam._kf_icp_rel.values()]
    n_rows, n_passed = slam.n_edge_icp
    n3d, n2d = slam.of_appended
    print(f"[inertial_geoflow] ICP accepted on {slam.n_icp_accepted} frames,"
          f" carried {slam.n_icp_carried}; {len(gates)} inter-KF "
          f"registrations held, {sum(gates)} with a passed gate; EdgeICP "
          f"rows into VI-BA: {n_rows} with a measurement, {n_passed} of "
          f"them with a passed gate; OF appended {n3d} 3D-stream and {n2d} "
          f"2D-stream points")
    if slam.n_icp_accepted < 1 or n3d + n2d <= 0:
        raise AssertionError("no ICP prediction accepted or no OF point")
    measured = [x for x in kept if bool((x[0].icp.t != 0).any())]
    if n_rows < 1 or not measured:
        raise AssertionError("no EdgeICP measurement entered VI-BA")
    _count(summary, "inertial_geoflow", launches, n_frames,
           {"gated_hamming_search": None, "hamming_best2": n_k4,
            "lk_pyramid": n_frames - 1})
    _check_edge_icp(*measured[-1])


def phase_dataset(summary, n_frames: int = DATASET_FRAMES):
    """The TUM RGB-D-inertial disk-to-trajectory path: io/fixtures exports
    DATASET_FRAMES + 2 x DATASET_EXTRA frames of the room at 640x480 (1000
    features, 8 levels, the TUM fr1 size of the reference's RGB-D yamls) at
    10 fps with 200 Hz IMU into a temporary directory, and
    tools/run_rgbd_tum.main runs the first DATASET_FRAMES of them on the
    card with --imu, --atlas and --out (no vocabulary: the driver's
    arguments are the JAX driver's, which builds its SlamSystem without
    one).
    Gates: state OK, the SE3-aligned ATE against the written groundtruth
    under the JAX driver test's 6 cm (tests/test_dataset_drivers.py), the
    shutdown file set; the atlas loaded into a fresh SlamSystem on the card
    with every MapState array equal to the saved map (n_maps one more, the
    active map the new one), and refused by a SlamSystem built with the
    shipped vocabulary (the checksums differ); then
    localization mode on the driver's system over DATASET_EXTRA frames
    from disk (the KF count frozen, OK on every frame) and DATASET_EXTRA
    frames after it (KFs inserted again). Launch counts over all its
    frames: the fused K1 once a frame, K2 launched, K4 once per
    relocalization attempt. Prints the frame times, the decoder (native or
    Python), the atlas's size and its save and load seconds."""
    import os
    import tempfile
    from geoflowslam_tpu_torch.io import datasets as DS
    from geoflowslam_tpu_torch.io import fixtures as FX
    from geoflowslam_tpu_torch.io import trajectory as TR
    from geoflowslam_tpu_torch.io.native_loader import FrameLoader
    from geoflowslam_tpu_torch.io.yaml_compat import system_config_from_yaml
    from geoflowslam_tpu_torch.state import serialize as SER
    from geoflowslam_tpu_torch.tools import run_rgbd_tum

    tag, extra = "dataset", DATASET_EXTRA
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    try:
        t0 = time.perf_counter()
        seq, settings, assoc = FX.export_tum_rgbd(
            f"{tmp}/seq", n_frames=n_frames + 2 * extra, fps=DATASET_FPS,
            width=640, height=480, n_features=1000, n_levels=8,
            device="cuda")
        print(f"[{tag}] exported {n_frames + 2 * extra} TUM frames 640x480 "
              f"at {DATASET_FPS:g} fps with 200 Hz IMU in "
              f"{time.perf_counter() - t0:.2f} s")
        attempts = []
        reloc_attempt = SlamSystem._reloc_attempt

        def counted(self, frame):
            attempts.append(1)
            return reloc_attempt(self, frame)
        SlamSystem._reloc_attempt = counted
        kernels.reset_launch_counts()
        try:
            res = run_rgbd_tum.main([
                settings, seq, assoc, "--imu", "--max-frames",
                str(n_frames), "--atlas", f"{tmp}/atlas", "--out",
                f"{tmp}/out", "--device", "cuda"])
            slam = res["slam"]
            stats = slam.map_stats()
            _check_atlas(tag, slam, f"{tmp}/atlas", settings, SER,
                         system_config_from_yaml)
            # localization mode, then mapping again, on the next frames
            frames = DS.load_tum_associations(seq, assoc)
            rows = DS.load_imu_txt(f"{seq}/imu/imu.txt")
            loader = FrameLoader([f.rgb_path for f in frames[n_frames:]],
                                 [f.depth_path for f in frames[n_frames:]],
                                 height=480, width=640)
            slam.activate_localization_mode()
            loc_kfs, loc_states = [], []
            for k, gray, depth in loader:
                i = n_frames + k
                if k == extra:
                    slam.deactivate_localization_mode()
                slam.track_rgbd_inertial(gray, depth, *DS.imu_between(
                    rows, frames[i - 1].time, frames[i].time,
                    slam.cfg.imu.max_samples_per_frame), frames[i].time)
                loc_kfs.append(slam.map_stats()["n_kfs"])
                loc_states.append(slam.state.name)
            loader.close()
            torch.cuda.synchronize()
        finally:
            SlamSystem._reloc_attempt = reloc_attempt
        launches = dict(kernels.launch_counts)
        ms = np.asarray(res["frame_ms"][1:])
        # the SE3-aligned ATE on the exported files, as the JAX driver
        # test evaluates them (tests/test_dataset_drivers.py)
        traj = TR.load_trajectory_tum(f"{tmp}/out/CameraTrajectory.txt")
        ate = ate_rmse(traj, TR.load_trajectory_tum(
            f"{seq}/groundtruth.txt"))["ate_rmse"]
        print(f"[{tag}] run_rgbd_tum --imu over {n_frames} frames from disk:"
              f" {stats}, {len(traj)} poses, ATE {ate * 100:.3f} cm; "
              f"decoder native: {str(res['native']).lower()}; ms/frame "
              f"median {np.median(ms):.2f}, p90 {np.percentile(ms, 90):.2f};"
              f" {len(attempts)} relocalization attempts")
        if stats["state"] != "OK" or not ate < 0.06 or len(traj) < 0.9 * (
                n_frames):
            raise AssertionError(f"{tag}: {stats}, ATE {ate} m, "
                                 f"{len(traj)} poses")
        names = set(os.listdir(f"{tmp}/out"))
        want = {"CameraTrajectory.txt", "KeyFrameTrajectory.txt", "map.html",
                "ExecTimeMean.txt", "LocalMapTimeStats.txt", "LBA_Stats.txt",
                "SessionInfo.txt", "TrackTimeCost.txt"}
        if not want <= names:
            raise AssertionError(f"{tag}: shutdown wrote {sorted(names)}")
        n_kfs = stats["n_kfs"]
        print(f"[{tag}] localization mode over {extra} frames: KFs "
              f"{loc_kfs[:extra]}, states {sorted(set(loc_states[:extra]))};"
              f" then {extra} frames mapping: KFs {n_kfs} -> {loc_kfs[-1]}")
        if (set(loc_kfs[:extra]) != {n_kfs}
                or set(loc_states[:extra]) != {"OK"}):
            raise AssertionError(f"{tag}: localization mode KFs {loc_kfs}, "
                                 f"states {loc_states}")
        if not loc_kfs[-1] > n_kfs or loc_states[-1] != "OK":
            raise AssertionError(f"{tag}: no KF after localization mode "
                                 f"({loc_kfs}, {loc_states})")
        _count(summary, tag, launches, n_frames + 2 * extra,
               {"gated_hamming_search": None,
                "hamming_best2": len(attempts)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_atlas(tag, slam, path, settings, SER, config_from_yaml):
    """A fresh SlamSystem on the card loads the atlas with every MapState
    array equal to the saved map but the Atlas bookkeeping that
    create_new_map moves on (n_maps one more, the new active map, the
    IMU flags cleared); a SlamSystem with the shipped vocabulary refuses
    the atlas, which was saved without one. Prints the size and the save
    and load seconds."""
    import os
    voc = slam.vocab
    t1 = time.perf_counter()
    slam.save_atlas(path + "_timed")
    save_s = time.perf_counter() - t1
    cfg, _ = config_from_yaml(settings, sensor="rgbd")
    fresh = SlamSystem(cfg, torch.device("cuda"), vocab=voc)
    t1 = time.perf_counter()
    fresh.load_atlas(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    saved, got = SER.ms_to_host(slam.ms), SER.ms_to_host(fresh.ms)
    moved = ("active_map", "n_maps", "imu_initialized", "viba1_done",
             "viba2_done")
    for f, a in saved.items():
        if f not in moved and not np.array_equal(a, got[f]):
            raise AssertionError(f"{tag}: atlas field {f} differs")
    if int(got["n_maps"]) != int(saved["n_maps"]) + 1 or int(
            got["active_map"]) != int(saved["n_maps"]):
        raise AssertionError(f"{tag}: n_maps {got['n_maps']} after loading "
                             f"{saved['n_maps']}")
    other = V.default_vocabulary("cuda")
    try:
        SlamSystem(cfg, torch.device("cuda"), vocab=other).load_atlas(path)
    except ValueError as e:
        refused = "checksum" in str(e)
    else:
        refused = False
    if not refused:
        raise AssertionError(f"{tag}: the shipped vocabulary was not "
                             f"refused")
    print(f"[{tag}] atlas {os.path.getsize(path + '.npz') / 2 ** 20:.2f} MB"
          f" (k_max {cfg.k_max}, m_max {cfg.m_max}), save {save_s:.3f} s, "
          f"load {load_s:.3f} s; every array equal, n_maps "
          f"{int(saved['n_maps'])} -> {int(got['n_maps'])}, refused with "
          f"the shipped vocabulary")


def _to(x, dev):
    """A tensor, or a NamedTuple of them (nested, None kept), on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(f, dev) for f in x))
    return x


def _check_edge_icp(prob, args):
    """The EdgeICP factor with information on the card. The main path's
    measured rows carry no information (no registration of the room passes
    its gate), so on one of its VI-BA problems the measured rows get
    information 1e2 (the reference's weight) and 1e5; for each,
    vi_local_ba on the card and on the CPU from the same inputs: KF
    positions within 1e-4 m and rotations within 1e-4 rad, velocities and
    biases within 1e-4; and rel_pose_terms' residual and Jacobians on the
    measured rows within 1e-5 of the CPU's. Prints how far the factor
    moved the KF positions from the solve without it, and gates on a move
    at 1e5."""
    icp = prob.icp
    rows = (icp.t != 0).any(-1)
    r, t = prob.vis.kf_rot, prob.vis.kf_t
    terms = (r[:-1][rows], t[:-1][rows], r[1:][rows], t[1:][rows],
             icp.rot[rows], icp.t[rows])
    got = VIBA.rel_pose_terms(*terms)
    want = VIBA.rel_pose_terms(*(_to(x, "cpu") for x in terms))
    err_terms = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(got, want))
    free, _ = VIBA.vi_local_ba(prob._replace(icp=None), *args)
    line = [f"{int(rows.sum())} measured rows of {rows.numel()}, kw "
            f"{r.shape[0]}; rel_pose_terms max |card - CPU| {err_terms:.2e}"]
    moved = {}
    for info in (1e2, 1e5):
        p = prob._replace(icp=icp._replace(info=torch.where(
            rows, torch.tensor(info, device=rows.device), 0.0)))
        t1 = time.perf_counter()
        out, _ = VIBA.vi_local_ba(p, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        ref, _ = VIBA.vi_local_ba(_to(p, "cpu"), *args)
        d_t = float((out.vis.kf_t.cpu() - ref.vis.kf_t).abs().max())
        d_r = float(torch.linalg.matrix_norm(
            out.vis.kf_rot.cpu() - ref.vis.kf_rot).max()) / np.sqrt(2.0)
        d_vb = max(float((out.kf_vel.cpu() - ref.kf_vel).abs().max()),
                   float((out.kf_bias.cpu() - ref.kf_bias).abs().max()))
        moved[info] = float((out.vis.kf_t - free.vis.kf_t).abs().max())
        line.append(f"info {info:g}: {ms:.2f} ms on the card, max |card - "
                    f"CPU| {d_t:.2e} m, {d_r:.2e} rad, velocity/bias "
                    f"{d_vb:.2e}; moved the KFs by {moved[info]:.2e} m")
        if not (d_t < 1e-4 and d_r < 1e-4 and d_vb < 1e-4):
            raise AssertionError(f"EdgeICP VI-BA at info {info:g}: card and "
                                 f"CPU differ ({d_t}, {d_r}, {d_vb})")
    print("[inertial_geoflow] EdgeICP on the card: " + "; ".join(line))
    if not err_terms < 1e-5:
        raise AssertionError(f"rel_pose_terms differ by {err_terms}")
    if not moved[1e5] > 1e-6:
        raise AssertionError("the EdgeICP factor moved no KF at info 1e5")


# The path phases run in three processes side by side on the one card: every
# path is host-bound (the card idles 85-95% of a frame), so three of them
# share it with little loss, and the whole script stays within half its
# 1200 s limit on a slow host (the hosts' pace varies ~1.7x from run to
# run: the paths one after another took 1014 s on one, over 1300 s on
# another). Each group is about a third of the work (hard, then the other
# vocabulary paths and the short RGB-D ones; inertial, the monocular
# paths and the dataset path, which joined the group with the least time;
# inertial_geoflow and the stereo paths and g1). The kernels are
# timed before the paths start, and the monocular path's K4 launches after
# they end, with the card to themselves.
PATH_GROUPS = (("hard", "merge", "merge_mesh", "of_icp", "rgbd", "reloc",
                "fused_step"),
               ("inertial", "mono_inertial", "mono", "dataset",
                "quickstart"),
               ("inertial_geoflow", "stereo_inertial", "g1",
                "stereo_fisheye", "mono_geoflow", "mesh_gba"))
VOCAB_PATHS = ("reloc", "merge", "merge_mesh", "hard", "inertial",
               "inertial_geoflow", "fused_step")
PATH_THREADS = 2     # torch's CPU threads in each path process


def run_path_group(group: int, out_dir: str) -> int:
    """Worker: drive the path phases of PATH_GROUPS[group] one after
    another, printing what they print; write their launch counts (and
    mono's kept K4 launches) under out_dir for main to merge."""
    torch.set_num_threads(PATH_THREADS)
    kernels.load()
    summary = new_summary()
    voc = None
    t_start = time.perf_counter()
    for name in PATH_GROUPS[group]:
        phase = globals()[f"phase_{name}"]
        t0 = time.perf_counter()
        if name in VOCAB_PATHS:
            voc = voc if voc is not None else _vocabulary()
            phase(summary, voc)
        else:
            phase(summary)
        print(f"[time] phase_{name}: {time.perf_counter() - t0:.1f} s "
              f"(group {group} total {time.perf_counter() - t_start:.1f} s)",
              flush=True)
    counts = {k: {"launches": v["launches"],
                  "launches_per_frame": v["launches_per_frame"]}
              for k, v in summary.items()}
    with open(f"{out_dir}/counts_{group}.json", "w") as f:
        json.dump(counts, f)
    with open(f"{out_dir}/fused_kf_{group}.json", "w") as f:
        json.dump({"syncs": FUSED_KF_SYNCS, "sites": FUSED_KF_SITES}, f)
    if MONO_K4:
        torch.save(MONO_K4, f"{out_dir}/mono_k4.pt")
    return 0


def run_paths(summary) -> None:
    """Start one process per PATH_GROUPS entry, wait for all, print each
    one's output in turn and merge its launch counts into `summary`; the
    first to fail stops the others and raises."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    logs = [open(f"{out_dir}/group_{g}.log", "w+")
            for g in range(len(PATH_GROUPS))]
    procs = [subprocess.Popen([sys.executable, __file__, "--path-group",
                               str(g), out_dir], stdout=log,
                              stderr=subprocess.STDOUT)
             for g, log in enumerate(logs)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for g, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        print(f"[paths] group {g} {PATH_GROUPS[g]}: exit {p.returncode}")
        print(log.read(), end="", flush=True)
        log.close()
    bad = [g for g, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"path groups {bad} failed")
    syncs, sites = [], {}
    for g in range(len(PATH_GROUPS)):
        with open(f"{out_dir}/counts_{g}.json") as f:
            for k, v in json.load(f).items():
                summary[k]["launches"] += v["launches"]
                summary[k]["launches_per_frame"].update(
                    v["launches_per_frame"])
        with open(f"{out_dir}/fused_kf_{g}.json") as f:
            kf = json.load(f)
        syncs += kf["syncs"]
        for site, n in kf["sites"].items():
            sites[site] = sites.get(site, 0) + n
    gate_fused_kf(syncs, sites)
    MONO_K4.update(torch.load(f"{out_dir}/mono_k4.pt"))
    shutil.rmtree(out_dir, ignore_errors=True)


def new_summary():
    return {k: dict(name=k, route="cuda", launches=0, launches_per_frame={},
                    entry_point_launches=0, **v)
            for k, v in KERNEL_INFO.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s "
              f"(total {time.perf_counter() - t_start:.1f} s)")
        return out
    name = phase_device()
    summary = new_summary()
    timed(phase_build)
    for phase in (phase_fast, phase_fast_fused, phase_hamming,
                  phase_hamming_best2, phase_lk, phase_lk_fused,
                  phase_entry_points, run_paths, time_mono_k4):
        timed(phase, summary)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_frame", "entry_point_launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "distance_matmul_ms", "path_shapes")
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
    if len(sys.argv) == 4 and sys.argv[1] == "--path-group":
        sys.exit(run_path_group(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
