"""RGB-D, stereo, monocular and their inertial SLAM façade of the port (the
synchronous counterpart of geoflowslam_tpu/pipeline/system.py).

Per frame, in the caller's thread, on the system's device:
  [m12 feed: pack on the host, unpack on the device] -> motion-model pose
  prediction -> build_frame -> [use_icp: GICP/NDT registration against the
  last frame as the pose predictor] -> [use_of: the dual-stream optical
  flow fills the frame's OF slots] -> track_with_motion_model ->
  track_local_map -> accept or reject (min_inliers_ok, OF confirmations
  discounted) -> NeedNewKeyFrame -> on a keyframe, one
  local_mapping.mapping_step -> trajectory record (t, T_cr, ref KF).
The RGB-D frames the reference runs through its fused step (`_can_fuse`:
tracking OK, or RECENTLY_LOST with a vocabulary; no record_reproj_err, not
in localization mode, a previous frame for OF/ICP) go through the port's
pipeline/fused.frame_step: every stage and decision on the device, the
frame's images staged through pinned memory, and one host read a frame,
its packet (inlier counts, VI verdict, twc, T_cr, bias, aux), from which
the host takes the reference's decisions (_process_pending with
pkt_max_pending 0: there is no deferred decision ring and no reader thread;
a local card needs neither). A registration is accepted only when it
converged, has enough inliers and moved plausibly (< 0.5 m, < ~20 deg); a
frame whose visual inliers collapse while the registration held is
ICP-carried: state OK at the registered pose, the motion model learns the
registered delta, and a keyframe without bindings every 0.5 s. A tracked
fused frame then steps the asynchronous global BA.

A keyframe takes the reference's fused KF step (_insert_keyframe_fused)
wherever the reference sends it there: the slot from a host mirror of the
KF slots (the lowest free slot, else the lowest dormant-map slot),
resynced by one read only after an event that relabels slots; one
local_mapping.mapping_step, which reads nothing on the host; BA's
correction folded into the tracked pose. The step's culled KF and, with
loop closing, the KF's place recognition are copied to the host without a
wait and applied `fused_lag` processed frames later (_drain_deferred, once
a fused frame after its outputs are adopted): the cull's bookkeeping (the
BoW erase, the IMU segment merge, the parent chain, T_culled<-parent from
the map as it then stands), and for a matured candidate the Sim3
verification and correction. The staged entry, `trajectory`, `map_stats`,
`save_atlas`, `save_session` and `shutdown` first apply them all; `reset`
and `reset_active_map` drop them. So a fused KF frame reads the device once
(its packet), once more when the mirror must be resynced or a loop
candidate matured. Initialization is
StereoInitialization. A KF-stall watchdog counts (`kf_stall_warnings`) and
warns when no keyframe has landed for 10 s of tracking.

A frame whose track fails is handled in one of two modes, as the reference's
façade handles it:
* fused (the reference's default path): with a vocabulary and without
  `record_reproj_err`. The failed frame holds the last pose, keeps the
  motion model and the bindings and goes RECENTLY_LOST at once. Every later
  frame while RECENTLY_LOST, and every frame once an ICP-carried streak
  reaches 30, runs the frame step's recovery variant, which reads once
  whether the track failed and then runs the 40 px re-search from the
  predicted pose and relocalization (pipeline/reloc.recover_frame: the
  re-search taken when it holds, adopted at >= max(min_inliers_ok, 30)
  inliers): the matched KF becomes the reference, the motion model
  identity, the pose is recorded without a reference KF. After
  `time_recently_lost` the state goes LOST and a new Atlas map starts.
* staged: with `record_reproj_err` (which also fills `f2f_reproj` and
  `f2m_reproj`), or without a vocabulary. A visual frame that fails the
  fused step without a vocabulary is re-run through the staged step from
  the state before it, as the reference re-runs it: it retries wider from
  the last pose, then (with a vocabulary) TrackReferenceKeyFrame; failing
  that it drops the motion model, and every RECENTLY_LOST frame, the first
  included, tries to relocalize (accepted at min_inliers_ok).

With an IMU (`cfg.imu`, `track_rgbd_inertial`) the frame follows the
reference's fused step with its imu_mode: "raw" preintegrates until the IMU
is initialized; "kf" and "prior" predict the pose from the last body state
(PredictStateIMU), track visually, then refine with the IMU factor against
the last KF-anchored state, or jointly with the last frame's state under its
marginal, and take the VI state when it keeps max(min_inliers_ok, half the
visual inliers). A lost frame dead-reckons the prediction; KFs come at
least every 0.5 s, and while lost (InsertKFsWhenLost). Without a vocabulary
the failed frame is re-run through the staged step from its adopted,
dead-reckoned outputs, as the reference re-runs it (the VI prior cleared,
the bias the frame preintegration's, the prediction made over the same gap
a second time; ROADMAP.md Queue 3), and the frames after it, which start
RECENTLY_LOST, take the staged step (below). Until the IMU is
initialized a KF takes the reference's staged KF step, which attempts the
initialization; after it, the mapping step runs VI-BA over the temporal
window (8 KFs, 16 for VIBA1 and VIBA2). An ICP-carried frame on the fused
path rides the registered pose with the dead-reckoned body state, as the
reference's fused step keeps it.

With `use_icp` every KF is also registered by GICP against the previous
KF's cloud (the last 40 KF clouds are kept); with the IMU a registration
that converged with >= 400 inliers, error < 0.01 and a translation within
0.1 m of its start (a device-side gate, or a host-side one on the staged KF
step) is an EdgeICP factor of VI-BA, information 1e2. With `use_of` the
optical-flow stage runs beside the IMU too, from the predicted pose.

With `use_lidar` (which turns on the frame's edge/surf feature cloud) every
frame refines its pose with the point-to-plane factors of its cloud against
the sliding local map (pipeline/lidar_mapping.py), 2 rounds x 5 GN
iterations over reprojection and planes, its bindings cut to the inliers:
on the fused path on every frame (an empty map yields no valid factor), on a
staged frame only when it tracked and the map holds points. A KF from a
tracked frame then takes the reference's staged KF step (create, local BA or
VI-BA, fusion and culling, the cloud into the local map at the optimized KF
pose and into the global map, loop detection; tracking goes on from the
KF's pose and live bindings without the motion model); the KFs of ICP-
carried and lost frames take the mapping step, their cloud into the global
map without a host read (GlobalMap.add_lazy).

With `use_odom`, `set_odom` queues base velocities. A frame that the
reference runs through its staged step (with record_reproj_err every frame;
without a vocabulary every frame that starts RECENTLY_LOST) and before the
IMU is initialized predicts its position from the last pose moved by the
mean queued velocity times the frame gap, keeping the predicted rotation,
and empties the queue; on the other frames the samples pile up, as in the
reference. The staged re-run of a visual frame that failed the fused step
without a vocabulary searches again from the last pose when its track
fails; with queued odometry it first searches from the re-run's odometry
prediction (its gap is 0: the predicted rotation at the last position).

The stereo entry points build the frame without depth and fill each
keypoint's depth and right u from a matcher: `track_stereo` from the
rectified pair's SAD search (ops/stereo.stereo_match), `track_stereo_fisheye`
(a dual-KB8 rig, `cfg.stereo_fisheye`) from the right image's own ORB
features matched and triangulated against the left's
(ops/stereo.fisheye_stereo_match: one more fused-FAST launch and one
best-two Hamming search a frame). Their `*_inertial` variants preintegrate
the samples first. Every stereo frame takes the staged step, as the
reference's stereo paths do, and so do the IMU frames that the reference
runs staged (with `record_reproj_err` every frame, without a vocabulary
every frame that starts RECENTLY_LOST). Its IMU branches: the pose
predicted from the last body state once the IMU is initialized; after the
local-map stage the VI refinement (against the last KF-anchored state, or
jointly with the last frame's state under its marginal), taken when it
keeps max(min_inliers_ok, half the visual inliers) inliers, otherwise the
VI prior dropped; the body state from the VI state (its marginal the next
prior) or from the pose with a finite-difference velocity; an ICP-carried
frame's body at the registered pose; a lost frame's KF from the prediction
(InsertKFsWhenLost); a relocalized frame's body at the new pose. Its time
guards reset the map and go on with the frame, where the fused path drops
it.

The monocular entry points (`sensor="mono"`) build the frame without depth
and take the staged step on every frame, as the reference's
`track_monocular` does. Initialization is MonocularInitialization
(pipeline/mono_init.py): the first frame with more than 100 keypoints is
held, each later frame is matched against it (one best-two Hamming launch)
and reconstructed from F or H; while that fails the held frame is replaced
once it is more than 1 s old. On success both KFs and the triangulated
points seed the map at median depth 1, and one local BA polishes it. A
monocular KF creates its points by triangulation against its three best
covisible KFs (local_mapping.triangulate_new_points: three more launches),
after the IMU block and before local BA or VI-BA. With the IMU
(`track_monocular_inertial`) the initialization solves the scale as well
(scale_free), ScaleRefinement re-pins it on a KF more than 5 s after the
init at most every 10 s, and VIBA1 and VIBA2 first re-run the
initialization (scale_free) and then the wide VI-BA; each of these folds
its map transform into the trajectory and re-anchors the tracked state on
the KF.

With a vocabulary (`SlamSystem(cfg, device, vocab=...)`) every KF enters a
BoW database (the loop closer's, or a standalone one without loop
closing). With `cfg.loop` as well, each KF runs place recognition after
its mapping step; a matured candidate is verified and closed
(pipeline/loop_closing.py: Atlas merge or pose graph, seam welding)
`fused_lag` processed frames later after a fused KF step, at once after a
staged one; the reference KF's correction is carried onto the current
pose and the global BA restarted as micro-steps (local_mapping.AsyncGBA),
one on each tracked fused frame and on each staged frame. With a mesh
(`SlamSystem(cfg, device, vocab, mesh=LandMesh([...]))`) the global BA's
micro-steps, and the synchronous global BA of `run_global_ba`, run
landmark-sharded over its devices (parallel/dist_ba.py).
"""
from __future__ import annotations

import dataclasses
import enum
import os
import warnings
from typing import Optional

import numpy as np
import torch

from geoflowslam_tpu_torch.config import LidarConfig, SystemConfig
from geoflowslam_tpu_torch.imu import preintegration as pre
from geoflowslam_tpu_torch.io import feed_codec as FC
from geoflowslam_tpu_torch.io import trajectory as TR
from geoflowslam_tpu_torch.math import cameras as CAM
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.ops import gicp as G
from geoflowslam_tpu_torch.ops import pyramid as pyr_ops
from geoflowslam_tpu_torch.ops import stereo as ST
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.parallel.dist_ba import LandMesh
from geoflowslam_tpu_torch.pipeline import fused as FU
from geoflowslam_tpu_torch.pipeline import inertial as IN
from geoflowslam_tpu_torch.pipeline import lidar_mapping as LD
from geoflowslam_tpu_torch.pipeline import local_mapping as LM
from geoflowslam_tpu_torch.pipeline import mono_init as MI
from geoflowslam_tpu_torch.pipeline import of_tracking as OF
from geoflowslam_tpu_torch.pipeline import reloc as R
from geoflowslam_tpu_torch.pipeline import tracking as T
from geoflowslam_tpu_torch.pipeline.loop_closing import LoopCloser
from geoflowslam_tpu_torch.retrieval import kf_database as DBD
from geoflowslam_tpu_torch.retrieval import vocab as Vv
from geoflowslam_tpu_torch.solvers import inertial_ba as VIBA
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state import serialize as S
from geoflowslam_tpu_torch.state.frame import (FrameData, build_frame,
                                               check_supported)
from geoflowslam_tpu_torch.utils.device_const import HostCopy, stage, upload
from geoflowslam_tpu_torch.utils.timers import StageTimers
from geoflowslam_tpu_torch.viewer.html_export import export_html


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


def check_config(cfg: SystemConfig) -> None:
    """Raise on options outside the ported RGB-D, stereo, stereo-fisheye and
    monocular paths and their inertial variants (each with OF, ICP, lidar,
    odometry, relocalization and loop closing)."""
    if cfg.sensor not in ("rgbd", "stereo", "mono"):
        raise NotImplementedError(f"not ported yet: sensor={cfg.sensor!r}")
    check_supported(cfg.frame)


class SlamSystem:
    """RGB-D SLAM on one device. `device` is required to be explicit; a CUDA
    device without CUDA raises instead of running on the CPU. `vocab`
    (retrieval/vocab.py) enables relocalization and, with cfg.loop, loop
    closing. `mesh` (a parallel.dist_ba.LandMesh) runs the global BA
    landmark-sharded over its devices, the partial systems reduced on its
    first device; the map stays on `device`."""

    def __init__(self, cfg: SystemConfig, device: torch.device | str,
                 vocab: Optional[Vv.Vocabulary] = None,
                 mesh: Optional[LandMesh] = None):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlamSystem: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        if cfg.use_lidar and not cfg.frame.lidar_features:
            # the point-to-plane factors take the edge/surf feature cloud
            cfg = dataclasses.replace(cfg, frame=dataclasses.replace(
                cfg.frame, lidar_features=True))
        check_config(cfg)
        self.cfg = cfg
        self.device = dev
        self.tcfg = cfg.track_cfg()
        self.mcfg = cfg.map_cfg()
        self.ms = M.create(cfg.k_max,
                           cfg.frame.orb.n_features + cfg.frame.n_of_slots,
                           cfg.m_max, dev)
        self.state = TrackingState.NOT_INITIALIZED
        self.cur_rot = torch.eye(3, device=dev)
        self.cur_t = torch.zeros(3, device=dev)
        self.vel = (torch.eye(3, device=dev), torch.zeros(3, device=dev))
        self.has_vel = False
        self.last_obs_mp: Optional[torch.Tensor] = None
        self.last_levels: Optional[torch.Tensor] = None
        self.local_masks = None
        self.ref_kf = 0
        self.ref_kf_inliers = 0
        self.frames_since_kf = 0
        self.last_time = 0.0
        self.time_base: Optional[float] = None
        self.lost_since: Optional[float] = None
        self.n_frames = 0
        self.n_lost = 0
        self.inlier_log = []          # (t, n_motion_model, n_local_map)
        # trajectory: (t, Twc) before the first KF, else (t, Twc, ref KF,
        # generation, T_cr 3x4); exported poses rebase onto the ref KF's
        # current pose (mlRelativeFramePoses), walking the chain of culled
        # KFs through their recorded T_culled<-parent
        self._traj: list = []
        self._lost_stamps: set = set()
        self._kf_gen: dict = {}
        self._gen_counter = 0
        self._culled_rel: dict = {}
        self._last_kf_time = 0.0
        # the KF step's results that the reference applies `fused_lag`
        # processed frames later (_drain_deferred): each KF's cull and, with
        # loop closing, its place recognition, copied to the host without a
        # wait; and the host mirror of the KF slots (validity, Atlas map, the
        # temporal parents) from which the KF step picks its slot, resynced
        # by one read after an event that relabels slots (_mirror_dirty)
        self._deferred: list = []
        self._kf_valid_h: Optional[np.ndarray] = None
        self._kf_map_h: Optional[np.ndarray] = None
        self._active_map_h = 0
        self._kf_prev_h: dict = {}
        self._mirror_dirty = True
        self.n_mirror_syncs = 0     # mirror resyncs (one host read each)
        self.n_loop_matured = 0     # matured loop candidates acted on
        # (processed frame of the detecting KF, processed frame where its
        # correction landed) of every loop or merge closed
        self.loop_events: list = []
        # OF/ICP stages: the previous frame (with its filled OF slots), the
        # RANSAC generator, and device-side counters read only on request
        self.last_frame: Optional[FrameData] = None
        self._gen = torch.Generator(device=dev)
        self._of_last = torch.zeros(2, dtype=torch.long, device=dev)
        self._of_total = torch.zeros(2, dtype=torch.long, device=dev)
        self._icp_accepted = torch.zeros((), dtype=torch.long, device=dev)
        # the frame step's packet: its pinned host buffer and event
        self._pkt_host: Optional[torch.Tensor] = None
        self._pkt_event = None
        self.n_icp_carried = 0
        self.n_staged_reruns = 0   # failed fused frames re-run staged
        self._carried_streak = 0   # consecutive ICP-carried frames
        # recovery and loop closing: the BoW database is the loop closer's,
        # or a standalone one when loop closing is off (the reference's
        # System-owned KeyFrameDatabase)
        self.vocab = vocab.to(dev) if vocab is not None else None
        self.loop_closer = (
            LoopCloser(self.vocab, cfg.k_max, cfg.loop, map_cfg=self.mcfg,
                       mesh=mesh, device=dev)
            if self.vocab is not None and cfg.loop is not None else None)
        self._reloc_db = (
            DBD.KFDatabase.create(cfg.k_max, self.vocab.n_words, dev)
            if self.vocab is not None and self.loop_closer is None else None)
        self._reloc_gen = torch.Generator(device=dev)
        self.n_reloc = 0              # relocalizations adopted
        self.n_recovered = 0          # frames adopted by recover_frame
        # KF-stall watchdog, per-stage wall times, and with
        # record_reproj_err the per-frame (t, mean px error, inliers) of the
        # motion-model and local-map stages
        self.kf_stall_warnings = 0
        self._last_stall_warn = -1e18
        self.timers = StageTimers()
        self.f2f_reproj: list = []
        self.f2m_reproj: list = []
        self._gba = (LM.AsyncGBA(self.mcfg, mesh=mesh)
                     if cfg.loop is not None else None)
        # with use_icp: slot -> (cloud, valid) of the last 40 KFs (the
        # inter-KF registrations and the loop closer's use_icp_loop), and
        # slot -> (rot, t, previous slot, gate) of the registration T_cw[slot]
        # T_cw[prev]^-1 (the EdgeICP factors of VI-BA)
        self._kf_clouds: dict = {}
        self._kf_icp_rel: dict = {}
        self._last_kf_slot: Optional[int] = None
        # EdgeICP rows that entered VI-BA: with a measurement, and of those
        # with a passed gate (device counters)
        self._edge_icp_rows = torch.zeros(2, dtype=torch.long, device=dev)
        # use_lidar: the sliding local map, the global map, and per frame
        # the number of valid plane factors (device scalars)
        self._lidar_cfg = LidarConfig()
        self.lidar_map = (LD.create_local_map(self._lidar_cfg, dev)
                          if cfg.use_lidar else None)
        self.global_map = (LD.GlobalMap(self._lidar_cfg) if cfg.use_lidar
                           else None)
        self._plane_log: list = []
        # use_odom: queued (frame, velocity) samples, and the frames whose
        # prediction consumed them
        self._odom_queue: list = []
        self.n_odom_frames = 0
        # the IMU: preintegration, body state and initialization, and the
        # marginal information of the last frame's VI state (the next
        # frame's prior; None after a KF or a rejected VI frame)
        self.imu = (IN.InertialTracker(cfg.imu, dev) if cfg.imu is not None
                    else None)
        self._vi_prior: Optional[torch.Tensor] = None
        self.imu_modes: dict = {}     # frames per imu_mode
        self.n_vi_accepted = 0        # frames whose VI state was accepted
        self._rig = None              # the stereo-fisheye rig on the device
        # monocular initialization: the held (frame, time), the RANSAC
        # generator, the attempts made; the last ScaleRefinement (seconds
        # since the first frame)
        self._pending_init_frame = None
        self._init_gen = torch.Generator(device=dev)
        self.n_init_attempts = 0
        self.mono_init_info: Optional[dict] = None
        self.n_triangulated: list = []    # points per monocular KF (device)
        self._last_scale_ref = -1e18
        self._reseed_generators()
        # localization mode: tracking only, the map frozen
        self._localization_only = False

    # -- public API ----------------------------------------------------------

    def track_rgbd(self, gray, depth, timestamp: float) -> np.ndarray:
        """Track one frame (gray [H, W] 0..255, depth [H, W] in metres x
        depth_map_factor, numpy or tensors; with feed_codec "m12" also an
        already-packed 1-D uint8 buffer, depth then unused). Returns Twc 4x4
        (float64). With an IMU configured the frame takes the inertial
        path without IMU samples."""
        return self._track(None, timestamp, None,
                           images=self._rgbd_images(gray, depth))

    def track_rgbd_inertial(self, gray, depth, acc, gyro, dts,
                            timestamp: float) -> np.ndarray:
        """Track one frame with the IMU samples since the previous frame:
        acc, gyro [S, 3] in the body frame, dts [S] (0 = padding), numpy or
        tensors (S <= ImuConfig.max_samples_per_frame). Returns Twc 4x4."""
        self._need_imu("track_rgbd_inertial")
        return self._track(None, timestamp, (acc, gyro, dts),
                           images=self._rgbd_images(gray, depth))

    def track_stereo(self, gray_l, gray_r, timestamp: float) -> np.ndarray:
        """Track one rectified stereo pair (gray [H, W] 0..255 each; the
        right camera bf / fx to the right of the left one). Returns Twc
        4x4."""
        return self._track(lambda: self._stereo_frame(gray_l, gray_r),
                           timestamp, None, staged=True)

    def track_stereo_inertial(self, gray_l, gray_r, acc, gyro, dts,
                              timestamp: float) -> np.ndarray:
        """track_stereo with the IMU samples since the previous frame (as
        track_rgbd_inertial takes them)."""
        self._need_imu("track_stereo_inertial")
        return self._track(lambda: self._stereo_frame(gray_l, gray_r),
                           timestamp, (acc, gyro, dts), staged=True)

    def track_stereo_fisheye(self, gray_l, gray_r,
                             timestamp: float) -> np.ndarray:
        """Track one frame of the dual-KB8 rig `cfg.stereo_fisheye` (the
        left camera's KB8 coefficients in cfg.frame.dist_params, camera_model
        "kb8"). Returns Twc 4x4."""
        return self._track(lambda: self._fisheye_frame(gray_l, gray_r),
                           timestamp, None, staged=True)

    def track_stereo_fisheye_inertial(self, gray_l, gray_r, acc, gyro, dts,
                                      timestamp: float) -> np.ndarray:
        """track_stereo_fisheye with the IMU samples since the previous
        frame."""
        self._need_imu("track_stereo_fisheye_inertial")
        return self._track(lambda: self._fisheye_frame(gray_l, gray_r),
                           timestamp, (acc, gyro, dts), staged=True)

    def track_monocular(self, gray, timestamp: float) -> np.ndarray:
        """Track one monocular frame (gray [H, W] 0..255, numpy or a
        tensor; cfg.sensor "mono"). Returns Twc 4x4 (float64)."""
        self._need_mono("track_monocular")
        return self._track(lambda: self._build(self._image(gray), None),
                           timestamp, None, staged=True)

    def track_monocular_inertial(self, gray, acc, gyro, dts,
                                 timestamp: float) -> np.ndarray:
        """track_monocular with the IMU samples since the previous frame (as
        track_rgbd_inertial takes them)."""
        self._need_mono("track_monocular_inertial")
        self._need_imu("track_monocular_inertial")
        return self._track(lambda: self._build(self._image(gray), None),
                           timestamp, (acc, gyro, dts), staged=True)

    def _need_mono(self, entry: str):
        if self.cfg.sensor != "mono":
            raise ValueError(f"{entry} needs SystemConfig(sensor='mono')")

    def _need_imu(self, entry: str):
        if self.imu is None:
            raise ValueError(f"{entry} needs SystemConfig.imu")

    def _track(self, make_frame, timestamp: float, imu_in,
               staged: bool = False, images=None):
        """One frame: the time guards, then initialization, the fused frame
        step or the staged frame step. `make_frame()` builds the frame, or
        `images` (the RGB-D entry points' device images) are built into it;
        `staged` sends every frame through the staged step (the stereo and
        monocular entry points; every entry point in localization mode).
        The RGB-D frames the reference runs fused (`_can_fuse`) go through
        pipeline/fused.frame_step."""
        if images is not None:
            make_frame = lambda: self._build(*images)    # noqa: E731
        self._t_rel(timestamp)
        started = (self.n_frames > 0
                   and self.state != TrackingState.NOT_INITIALIZED)
        staged = staged or self._localization_only or (
            self.imu is not None and (
                self.cfg.record_reproj_err
                or (self.vocab is None
                    and self.state == TrackingState.RECENTLY_LOST)))
        fused = (started and not staged and images is not None
                 and self._can_fuse())
        if started and self.imu is not None and not fused:
            staged = True     # the reference's staged step, as it runs it
        if not fused:
            # the reference's staged entry first applies every deferred KF
            # result (its _flush_pending)
            self._drain_deferred(force=True)
        if (started and self.imu is not None and not staged
                and self._imu_guard(timestamp)):
            return self.current_pose_wc()
        if (started and self.imu is None and not staged
                and timestamp < self.last_time and self._can_fuse()):
            # the reference's fused step drops the frame: no track, no
            # count, no pose, last_time kept
            warnings.warn("frame timestamp older than the previous frame: "
                          "resetting the active map")
            self.reset_active_map()
            return self.current_pose_wc()
        p_frame = None
        if staged and imu_in is not None:
            # the reference preintegrates a staged frame before its guards
            p_frame = self.imu.preintegrate_frame(*imu_in, timestamp)
            imu_in = None
        if started and timestamp < self.last_time:
            warnings.warn("frame timestamp older than the previous frame: "
                          "resetting the active map")
            self.reset_active_map()
        elif (started and staged and self.imu is not None
              and timestamp - self.last_time > self.cfg.max_frame_gap):
            warnings.warn(f"timestamp jump of "
                          f"{timestamp - self.last_time:.2f}s with IMU: map "
                          "recovery")
            if self.imu.initialized:
                self._reset_or_new_map()
            else:
                self.reset_active_map()
        twc = None
        with self.timers.time("Track_total"):
            frame = None if fused else make_frame()
            if self.state == TrackingState.NOT_INITIALIZED:
                if imu_in is not None:
                    self.imu.preintegrate_frame(*imu_in, timestamp)
                self._initialize(frame, timestamp)
            elif fused:
                frame, twc = self._track_fused(images, imu_in, timestamp)
            else:
                frame, twc = self._track_frame(frame, timestamp, p_frame,
                                               staged)
        if (not fused and self._gba is not None and self._gba.active
                and self._gba.step()):
            self._finish_gba()
        if self.cfg.use_of or self.cfg.use_icp:
            self.last_frame = frame
        self.last_time = timestamp
        self.n_frames += 1
        self.last_levels = frame.feat.level
        return twc if twc is not None else self._record_pose(timestamp)

    def _rgbd_images(self, gray, depth):
        """The RGB-D frame's images on the device in the configured feed,
        host arrays copied through pinned memory without a wait: with
        feed_codec "m12" a (gray, depth) pair is packed on the host
        (io/feed_codec.pack_m12) and an already-packed 1-D buffer passes
        through, depth then None."""
        if self.cfg.frame.feed_codec == "m12" and np.ndim(gray) != 1:
            gray = FC.pack_m12(_host(gray), _host(depth),
                               self.cfg.frame.depth_map_factor)
        gray = upload(gray, self.device)
        depth = None if gray.dim() == 1 else upload(depth, self.device)
        return gray, depth

    def _build(self, gray, depth) -> FrameData:
        c = self.cfg
        return build_frame(gray, depth, c.frame, c.fx, c.fy, c.cx, c.cy)

    def _image(self, gray) -> torch.Tensor:
        return torch.as_tensor(gray).to(self.device).float()

    def _stereo_frame(self, gray_l, gray_r) -> FrameData:
        """The left image's frame with each keypoint's depth and right u
        from the rectified pair's SAD search."""
        gl, gr = self._image(gray_l), self._image(gray_r)
        frame = self._build(gl, None)
        ur, depth = ST.stereo_match(gl, gr, frame.feat.uv, frame.feat.valid,
                                    self.cfg.bf)
        return frame._replace(u_right=ur, depth_kp=depth)

    def _fisheye_rig(self):
        """(left KB8 parameters, right KB8 parameters, r_lr, t_lr, sigma^2
        per level) of the stereo-fisheye rig on the device."""
        if self._rig is None:
            c, sf = self.cfg, self.cfg.stereo_fisheye
            if sf is None or c.frame.camera_model != "kb8":
                raise ValueError("track_stereo_fisheye needs "
                                 "SystemConfig.stereo_fisheye and "
                                 "camera_model 'kb8'")
            f32 = dict(dtype=torch.float32, device=self.device)
            self._rig = (
                torch.tensor([c.fx, c.fy, c.cx, c.cy, *c.frame.dist_params],
                             **f32),
                torch.tensor(sf.params_r, **f32),
                torch.tensor(sf.r_lr, **f32).reshape(3, 3),
                torch.tensor(sf.t_lr, **f32),
                torch.tensor([x * x for x in c.frame.orb.scale_factors()],
                             **f32))
        return self._rig

    def _fisheye_frame(self, gray_l, gray_r) -> FrameData:
        """The left image's frame (keypoints undistorted to the
        pinhole-equivalent grid) with depth from the right image: CLAHE and
        ORB on the right image, the left rays from the undistorted uv (their
        raw u, for the lapping gate, re-projected through KB8), the right
        rays through the right camera's KB8, matched and triangulated; the
        OF slots stay without depth."""
        c, sf = self.cfg, self.cfg.stereo_fisheye
        params_l, params_r, r_lr, t_lr, sig2 = self._fisheye_rig()
        frame = self._build(self._image(gray_l), None)
        gr = self._image(gray_r)
        featr = extract(pyr_ops.clahe(gr) if c.frame.use_clahe else gr,
                        c.frame.orb)
        n = c.frame.orb.n_features
        f = frame.feat
        uv_l, valid_l = f.uv[:n], f.valid[:n]
        rays_l = CAM.pinhole_unproject(params_l[:4], uv_l)
        uraw_l = CAM.kb8_project(params_l, rays_l)[:, 0]
        rays_r = CAM.kb8_unproject(params_r, featr.uv)
        mask_l = (valid_l & (uraw_l >= sf.lapping_l[0])
                  & (uraw_l <= sf.lapping_l[1]))
        ur_r = featr.uv[:, 0]
        mask_r = (featr.valid & (ur_r >= sf.lapping_r[0])
                  & (ur_r <= sf.lapping_r[1]))
        depth, _, _ = ST.fisheye_stereo_match(
            rays_l, f.desc[:n], mask_l, sig2[f.level[:n].long()], rays_r,
            featr.desc, mask_r, sig2[featr.level.long()], r_lr, t_lr,
            f_err=float(c.fx))
        ur = torch.where(depth > 0,
                         uv_l[:, 0] - c.bf / torch.clamp_min(depth, 1e-6),
                         -1.0)
        pad = frame.depth_kp.shape[0] - n
        if pad > 0:
            depth = torch.cat([depth, depth.new_full((pad,), -1.0)])
            ur = torch.cat([ur, ur.new_full((pad,), -1.0)])
        return frame._replace(depth_kp=depth, u_right=ur)

    def map_stats(self):
        """KF and map-point counts, Atlas maps and the tracking state, after
        every deferred KF result is applied (as the reference's map_stats
        drains its pipeline first)."""
        self._drain_deferred(force=True)
        return {
            "n_kfs": int(self.ms.kf_valid.sum()),
            "n_mps": int(self.ms.mp_valid.sum()),
            "n_maps": int(self.ms.n_maps),
            "state": self.state.name,
        }

    @property
    def debug_of(self):
        """(n_3d, n_2d) points the optical-flow stage appended to the last
        frame."""
        return tuple(int(x) for x in self._of_last.cpu())

    @property
    def of_appended(self):
        """(n_3d, n_2d) optical-flow points appended since the system
        started."""
        return tuple(int(x) for x in self._of_total.cpu())

    @property
    def n_icp_accepted(self) -> int:
        """Frames whose ICP registration passed the predictor's gates."""
        return int(self._icp_accepted)

    @property
    def n_edge_icp(self):
        """(EdgeICP rows with a measurement, of those with a passed gate),
        summed over the VI-BA windows they entered."""
        return tuple(int(x) for x in self._edge_icp_rows.cpu())

    @property
    def plane_factor_counts(self):
        """[(t, valid point-to-plane factors)] of the frames that ran the
        lidar stage (the last 2048 to 4096)."""
        if not self._plane_log:
            return []
        n = torch.stack([c for _, c in self._plane_log]).cpu().tolist()
        return [(t, int(c)) for (t, _), c in zip(self._plane_log, n)]

    def set_odom(self, vel, odom_frame: bool = True):
        """Queue a base-velocity sample (Tracking::GrabOdomData). With
        `odom_frame` it is in the robot's odometry frame and is rotated into
        the camera frame by `r_odom_cam` (identity when unset); with
        odom_frame=False it is a world-frame velocity."""
        v = np.asarray(_host(vel), np.float32)
        if odom_frame and self.cfg.r_odom_cam is not None:
            r = np.asarray(self.cfg.r_odom_cam, np.float32).reshape(3, 3)
            self._odom_queue.append(("cam", r @ v))
        elif odom_frame:
            self._odom_queue.append(("cam", v))
        else:
            self._odom_queue.append(("world", v))

    def current_pose_wc(self) -> np.ndarray:
        """Twc 4x4 (camera-to-world), float64."""
        return _twc(self.cur_rot.cpu().numpy(), self.cur_t.cpu().numpy())

    @property
    def trajectory(self):
        """[(t, Twc 4x4)] with lost frames skipped and every entry rebased
        onto its reference KF's current pose (SaveTrajectoryTUM), after
        every deferred KF result is applied."""
        self._drain_deferred(force=True)
        kf_rot = self.ms.kf_rot.cpu().numpy().astype(np.float64)
        kf_t = self.ms.kf_t.cpu().numpy().astype(np.float64)
        kf_valid = self.ms.kf_valid.cpu().numpy()
        out = []
        for e in self._traj:
            if round(e[0], 6) in self._lost_stamps:
                continue
            if len(e) == 2:
                out.append(e)
                continue
            ts, twc, ref, gen, trel = e
            hops = 0
            while (ref, gen) in self._culled_rel and hops < 64:
                prev, pgen, tcp = self._culled_rel[(ref, gen)]
                tcp = np.asarray(tcp, np.float64)
                r_cr, t_cr = trel[:, :3], trel[:, 3]
                trel = np.concatenate([r_cr @ tcp[:, :3],
                                       (r_cr @ tcp[:, 3] + t_cr)[:, None]], 1)
                ref, gen = prev, pgen
                hops += 1
            if not (0 <= ref < len(kf_valid) and bool(kf_valid[ref])
                    and self._kf_gen.get(ref) == gen):
                out.append((ts, twc))
                continue
            r_cw = trel[:, :3] @ kf_rot[ref]
            t_cw = trel[:, :3] @ kf_t[ref] + trel[:, 3]
            out.append((ts, _twc(r_cw, t_cw)))
        return out

    @property
    def reloc_db(self) -> Optional[DBD.KFDatabase]:
        """The relocalization BoW database (the loop closer's when loop
        closing is on)."""
        if self.loop_closer is not None:
            return self.loop_closer.db
        return self._reloc_db

    def reset_active_map(self):
        """System::ResetActiveMap: reinitialize in a fresh Atlas map; the
        KF clouds, EdgeICP measurements and local cloud map of the old one
        go."""
        self._drop_map(M.create_new_map(self.ms))

    def reset(self):
        """System::Reset: wipe the whole Atlas and restart, the IMU tracker
        anew. As in the JAX package, the BoW entries of the loop closer's or
        the reloc store's database stay as they are; a running asynchronous
        global BA is dropped with the map it was solving."""
        c = self.cfg
        self._drop_map(M.create(c.k_max,
                                c.frame.orb.n_features + c.frame.n_of_slots,
                                c.m_max, self.device))
        self.last_frame = None
        if self._gba is not None:
            self._gba.abort()
        if self.imu is not None:
            self.imu = IN.InertialTracker(c.imu, self.device)

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode: tracking only, the map frozen.
        Every frame takes the staged step, no keyframe is inserted (so no
        mapping, BoW entry or loop check) and the KF-stall watchdog is
        quiet."""
        self._localization_only = True

    def deactivate_localization_mode(self):
        self._localization_only = False

    def save_atlas(self, path: str):
        """System::SaveAtlas: the map to <path>.npz (state/serialize.py,
        the JAX package's format) with the vocabulary checksum, after every
        deferred KF result is applied."""
        self._drain_deferred(force=True)
        S.save_atlas(path, self.ms, self.vocab,
                     extra={"sensor": self.cfg.sensor,
                            "n_frames": self.n_frames,
                            "time_base": self.time_base or 0.0})

    def load_atlas(self, path: str) -> dict:
        """System::LoadAtlas: restore the map onto the system's device (the
        vocabulary checksum must match) with a new active map on top for
        the ongoing session, as the reference does; tracking starts
        NOT_INITIALIZED on the saved session's time base. Returns the
        atlas's extra metadata."""
        self._mirror_dirty = True
        ms, extra = S.load_atlas(path, self.vocab, device=self.device)
        self.ms = M.create_new_map(ms)
        self.state = TrackingState.NOT_INITIALIZED
        tb = extra.get("time_base")
        if tb is not None:
            self.time_base = float(tb)
        return extra

    def save_session(self, path: str):
        """Checkpoint the whole session (map, tracking, IMU, BoW database)
        so that `load_session` continues it mid-stream
        (state/serialize.save_session), after every deferred KF result is
        applied."""
        self._drain_deferred(force=True)
        S.save_session(path, self)

    def load_session(self, path: str) -> dict:
        """Restore a `save_session` checkpoint (the same SystemConfig
        capacities) and continue tracking from the checkpointed frame."""
        return S.load_session(path, self)

    def shutdown(self, save_dir: Optional[str] = None):
        """System::Shutdown: with `save_dir`, write the timers' files
        (utils/timers.write_all with the session info), CameraTrajectory.txt
        and KeyFrameTrajectory.txt (TUM format, absolute timestamps),
        map.html, globalMap.pcd with use_lidar, and
        Frame2FrameReprojErr.txt / Frame2MapReprojErr.txt when
        record_reproj_err filled them. Every deferred KF result is applied
        first, with or without save_dir."""
        self._drain_deferred(force=True)
        if save_dir is None:
            return
        os.makedirs(save_dir, exist_ok=True)
        self.timers.write_all(save_dir, {
            "sensor": self.cfg.sensor, "n_frames": self.n_frames,
            "n_lost": self.n_lost, **self.map_stats()})
        if self.lidar_map is not None:
            self.global_map.save_pcd(os.path.join(save_dir, "globalMap.pcd"))
        traj = self.trajectory
        TR.save_trajectory_tum(os.path.join(save_dir, "CameraTrajectory.txt"),
                               traj)
        TR.save_trajectory_tum(
            os.path.join(save_dir, "KeyFrameTrajectory.txt"),
            TR.keyframe_trajectory(self.ms, time_base=self.time_base or 0.0))
        export_html(self.ms, traj, self.cur_rot, self.cur_t,
                    path=os.path.join(save_dir, "map.html"))
        for name, rows in (("Frame2FrameReprojErr.txt", self.f2f_reproj),
                           ("Frame2MapReprojErr.txt", self.f2m_reproj)):
            if rows:
                with open(os.path.join(save_dir, name), "w") as f:
                    f.write("#t mean_err_px n_inliers\n")
                    for t, e, n in rows:
                        f.write(f"{t:.6f} {e:.4f} {n}\n")

    # -- internals -------------------------------------------------------------

    def _drop_map(self, ms: M.MapState):
        """Reinitialize on `ms`: the deferred KF results, the KF clouds,
        EdgeICP measurements and local cloud map of the old map go, and the
        slot mirror is resynced at the next KF."""
        self.ms = ms
        self._deferred.clear()
        self._mirror_dirty = True
        self._kf_prev_h.clear()
        self._kf_clouds.clear()
        self._kf_icp_rel.clear()
        self._last_kf_slot = None
        if self.lidar_map is not None:
            self.lidar_map = LD.create_local_map(self._lidar_cfg, self.device)
        self._pending_init_frame = None
        self._restart()

    def _reseed_generators(self):
        """The RANSAC and OF draws' generators at their constructors' seeds
        (also after a restored session: the draws are not checkpointed)."""
        self._gen.manual_seed(0)
        self._reloc_gen.manual_seed(1234)
        self._init_gen.manual_seed(1234)
        if self.loop_closer is not None:
            self.loop_closer.gen.manual_seed(LoopCloser.GEN_SEED)

    def _restart(self):
        self.state = TrackingState.NOT_INITIALIZED
        self.has_vel = False
        self.last_obs_mp = None
        self.local_masks = None
        self._vi_prior = None

    def _can_fuse(self) -> bool:
        """The reference's choice of its fused frame step for a frame of the
        RGB-D entry points: tracking OK, or RECENTLY_LOST with a
        vocabulary; without record_reproj_err; outside localization mode;
        with bindings to track from; with OF or ICP, a previous frame."""
        if (self.cfg.use_of or self.cfg.use_icp) and self.last_frame is None:
            return False
        if self._localization_only:
            return False
        healthy = self.state == TrackingState.OK
        recovering = (self.state == TrackingState.RECENTLY_LOST
                      and self.vocab is not None)
        return ((healthy or recovering) and not self.cfg.record_reproj_err
                and self.last_obs_mp is not None)

    def _imu_guard(self, timestamp: float) -> bool:
        """The reference's frame-time guards with an IMU (its fused path):
        an older timestamp resets the active map, a gap over max_frame_gap
        starts a new map (a reset before the IMU is initialized); the frame
        itself is dropped. Returns True when it dropped the frame."""
        if timestamp < self.last_time:
            warnings.warn("frame timestamp older than the previous frame: "
                          "resetting the active map")
            self.reset_active_map()
            return True
        if timestamp - self.last_time > self.cfg.max_frame_gap:
            warnings.warn(f"timestamp jump of "
                          f"{timestamp - self.last_time:.2f}s with IMU: map "
                          "recovery")
            if self.imu.initialized:
                self._reset_or_new_map()
            else:
                self.reset_active_map()
            return True
        return False

    def _t_rel(self, timestamp: float) -> float:
        """Seconds since the session's first frame (f64 on the host; small
        enough for exact float32 storage in the map)."""
        if self.time_base is None:
            self.time_base = float(timestamp)
        return float(timestamp) - self.time_base

    def _free_kf_slot(self) -> int:
        """A slot for the next KF of the staged KF step (map_state.
        free_kf_slot's choice, read from the device)."""
        self._ensure_kf_capacity()
        return int(M.free_kf_slot(self.ms))

    def _ensure_kf_capacity(self):
        """When every slot holds a live KF of the active map, force an
        aggressive redundancy cull, or raise."""
        if int(M.kf_capacity_left(self.ms)) > 0:
            return
        ms, culled = LM.keyframe_culling(
            self.ms, self.ref_kf, protect_recent=0.25, redundancy=0.6)
        culled_i = int(culled)
        if culled_i >= 0:
            self.ms = ms
            self._on_kf_culled(culled_i)
        if int(M.kf_capacity_left(self.ms)) == 0:
            raise RuntimeError(
                f"KeyFrame capacity exhausted: all {self.ms.k_max} slots "
                "hold live KFs of the active map and none is redundant "
                "enough to cull. Raise SystemConfig.k_max.")

    def _host_slot_mirror(self):
        """(kf_valid, kf_map_id, active map) of the host mirror, resynced
        from the map in one read when dirty (with the temporal parents of
        the valid slots)."""
        if self._mirror_dirty:
            ms = self.ms
            rows = torch.stack([
                ms.kf_valid.to(torch.int32), ms.kf_map_id.to(torch.int32),
                ms.kf_prev.to(torch.int32),
                ms.active_map.to(torch.int32).expand(ms.k_max)])
            h = rows.cpu().numpy()
            self._kf_valid_h = h[0] > 0
            self._kf_map_h = h[1].copy()
            self._active_map_h = int(h[3, 0])
            self._kf_prev_h = {i: int(p) for i, p in enumerate(h[2])
                               if self._kf_valid_h[i]}
            self._mirror_dirty = False
            self.n_mirror_syncs += 1
        return self._kf_valid_h, self._kf_map_h, self._active_map_h

    def _fused_kf_slot(self) -> int:
        """The fused KF step's slot, from the host mirror: the lowest free
        slot, else the lowest dormant-map slot; with neither, the capacity
        cull (or its error) and a resync. A culled KF's slot stays taken in
        the mirror until its cull is applied, `fused_lag` frames later."""
        kv, km, am = self._host_slot_mirror()
        free = np.flatnonzero(~kv)
        if len(free) == 0:
            dormant = np.flatnonzero(kv & (km != am))
            if len(dormant):
                free = dormant
            else:
                self._mirror_dirty = True
                self._ensure_kf_capacity()
                kv, km, am = self._host_slot_mirror()
                free = np.flatnonzero(~kv)
                if len(free) == 0:
                    free = np.flatnonzero(km != am)
        return int(free[0])

    def _initialize(self, frame: FrameData, timestamp: float):
        if self.cfg.sensor == "mono":
            return self._initialize_mono(frame, timestamp)
        slot = self._free_kf_slot()
        ms, res = T.stereo_initialization(self.ms, frame,
                                          self._t_rel(timestamp), slot,
                                          self.tcfg)
        n = int(res.n_inliers)
        if n < 50:
            return  # not enough depth points; wait for a better frame
        self.ms = ms
        self.cur_rot, self.cur_t = res.rot, res.t
        self.last_obs_mp = res.obs_mp
        self.local_masks = None
        self.ref_kf = slot
        self.ref_kf_inliers = n
        self.frames_since_kf = 0
        self._last_kf_time = timestamp
        self.state = TrackingState.OK
        self._gen_counter += 1
        self._kf_gen[slot] = self._gen_counter
        self._db_insert_kf(slot)
        if self.imu is not None:
            self.imu.pending = None     # the first KF has no segment
            self.imu.on_keyframe(slot)
            self.imu.body = self.imu.body_from_cam(self.cur_rot, self.cur_t)

    def _initialize_mono(self, frame: FrameData, timestamp: float):
        """Tracking::MonocularInitialization: hold a frame with more than 100
        keypoints, reconstruct against each later one; while that fails,
        the held frame is replaced once it is more than 1 s old. On success
        both KFs and the points seed the map, the IMU registers both KFs
        (the first-to-second samples fold into the next segment), and one
        local BA polishes the map (the tracked pose stays the init's)."""
        if self._pending_init_frame is None:
            if int(frame.feat.valid.sum()) > 100:
                self._pending_init_frame = (frame, timestamp)
            return
        f1, t1 = self._pending_init_frame
        c = self.cfg
        self.n_init_attempts += 1
        init = MI.try_monocular_init(self._init_gen, f1, frame, c.fx, c.fy,
                                     c.cx, c.cy, use_gms=c.use_gms_init)
        if not bool(init.ok):
            if timestamp - t1 > 1.0:
                self._pending_init_frame = (frame, timestamp)
            return
        ms, s1, s2, obs2, n_pts = MI.create_initial_map_mono(
            self.ms, f1, frame, init, self._t_rel(t1),
            self._t_rel(timestamp), c.frame.orb.scale_factor,
            c.frame.orb.n_levels)
        self.ms = ms
        self.cur_rot, self.cur_t = init.rot21, init.t21
        self.last_obs_mp = obs2
        self.local_masks = None
        self.ref_kf = s2
        self.ref_kf_inliers = int(n_pts)
        self.frames_since_kf = 0
        self._last_kf_time = timestamp
        self.state = TrackingState.OK
        self._gen_counter += 2
        self._kf_gen[s1] = self._gen_counter - 1
        self._kf_gen[s2] = self._gen_counter
        self._db_insert_kf(s1)
        self._db_insert_kf(s2)
        self._pending_init_frame = None
        self.mono_init_info = dict(time=timestamp, points=int(n_pts),
                                   homography=bool(init.use_h),
                                   attempts=self.n_init_attempts)
        if self.imu is not None:
            self.imu.pending = None
            self.imu.on_keyframe(s1)
            self.imu.on_keyframe(s2)
            self.imu.body = self.imu.body_from_cam(self.cur_rot, self.cur_t)
        # the reference runs GlobalBundleAdjustemnt(20) here
        self.ms, _ = LM.local_ba_step(self.ms, s2, self.mcfg)

    def _db_insert_kf(self, slot: int):
        """Enter a KF into the BoW database; for loop-closing systems the
        per-KF detect step does this itself after initialization."""
        if self.vocab is None:
            return
        db = DBD.add_keyframe(self.reloc_db, self.vocab, slot,
                              self.ms.kf_desc[slot],
                              self.ms.kf_kp_valid[slot])
        if self.loop_closer is not None:
            self.loop_closer.db = db
        else:
            self._reloc_db = db

    def _track_frame(self, frame: FrameData, timestamp: float,
                     p_frame: Optional[pre.Preintegrated] = None,
                     staged: bool = False):
        """Track one frame after initialization outside the fused step: the
        frames the reference does not fuse, and the staged re-run of a
        failed fused frame without a vocabulary. Returns the frame with its
        OF slots filled (the next frame's optical-flow source) and the Twc
        it recorded mid-step, or None when the pose is still to record.
        `staged`: the frame takes the reference's staged step from the start
        (the stereo frames, and the IMU frames the reference runs staged),
        with its IMU branches; `p_frame` is then the frame's preintegration
        (host), None without samples. Otherwise (the visual frames that
        start RECENTLY_LOST without a vocabulary, or without a previous
        frame for OF/ICP, and the re-runs) a failed track retries wider,
        from the odometry first when it is queued, then against the
        reference KF with a vocabulary: the reference's staged re-run."""
        cfg, imu = self.cfg, self.imu
        min_ok = cfg.min_inliers_ok
        last_rot, last_t = self.cur_rot, self.cur_t
        vi_on = (imu is not None and imu.initialized and imu.body is not None
                 and p_frame is not None)
        p_dev = pred_body = None
        if imu is not None:
            mode = ("off" if p_frame is None else "raw" if not vi_on
                    else "kf" if self._vi_prior is None else "prior")
            self.imu_modes[mode] = self.imu_modes.get(mode, 0) + 1
        if vi_on:
            # PredictStateIMU from the last body state
            p_dev = pre.to_device(p_frame, self.device)
            pred_body = imu.predict(p_dev)
            pr, pt = imu.cam_from_body(pred_body)
        elif self.has_vel:
            pr, pt = lie.se3_compose(self.vel[0], self.vel[1], last_rot,
                                     last_t)
        else:
            pr, pt = last_rot, last_t
        staged_run = staged or cfg.record_reproj_err
        if (cfg.use_odom and self._odom_queue
                and not (imu is not None and imu.initialized)
                and (staged_run
                     or (self.vocab is None
                         and self.state != TrackingState.OK))):
            pr, pt = self._odom_predict(pr, pt, timestamp)
        icp_ok = None
        if (cfg.use_icp and self.last_frame is not None
                and (not staged or bool(frame.cloud_valid.any()))):
            pr, pt, icp_ok = self._icp_predict(frame, pr, pt)
        frame, extra_obs, of_innov = self._of_stage(frame, pr, pt)
        res = T.track_with_motion_model(self.ms, frame, self.last_obs_mp, pr,
                                        pt, self.tcfg, self.last_levels,
                                        extra_obs=extra_obs)
        n1 = int(res.n_inliers)
        # the reference's staged step: from the start, or as the re-run of a
        # failed frame (the fallbacks below)
        staged_step = staged_run or n1 < min_ok
        if (n1 < min_ok and cfg.use_odom and self._odom_queue
                and not (icp_ok is not None and bool(icp_ok))):
            # the reference re-runs a failed frame that ICP did not carry
            # through its staged step, which predicts from the odometry
            # after the dispatch has stamped the frame's time: a zero gap,
            # the predicted rotation at the last position
            res = T.track_with_motion_model(
                self.ms, frame, self.last_obs_mp,
                *self._odom_predict(pr, pt, self.last_time), self.tcfg,
                self.last_levels, extra_obs=extra_obs)
            n1 = int(res.n_inliers)
        if n1 < min_ok:
            # search wider from the unpredicted pose
            wide = dataclasses.replace(self.tcfg, search_radius_mm=40.0)
            res = T.track_with_motion_model(self.ms, frame, self.last_obs_mp,
                                            last_rot, last_t, wide,
                                            self.last_levels)
            n1 = int(res.n_inliers)
        if n1 < min_ok and self.vocab is not None:
            # BoW-gated matching against the reference KF
            wf = Vv.descend(self.vocab, frame.feat.desc, frame.feat.valid)
            wk = Vv.descend(self.vocab, self.ms.kf_desc[self.ref_kf],
                            self.ms.kf_kp_valid[self.ref_kf])
            res = T.track_reference_keyframe(self.ms, frame, wf, wk,
                                             self.ref_kf, last_rot, last_t,
                                             self.tcfg)
            n1 = int(res.n_inliers)
        ms2, res2 = self.ms, res
        if n1 >= min_ok:
            if self.local_masks is None:
                self.local_masks = M.local_window(
                    self.ms, self.ref_kf, self.tcfg.local_window,
                    self.tcfg.lm_max_candidates)
            ms2, res2 = T.track_local_map(self.ms, frame, res.obs_mp, res.rot,
                                          res.t, self.tcfg, self.local_masks)
        n2 = res2.n_inliers
        if of_innov is not None and not staged_run:
            # the fused step's health count: OF-slot inliers whose track
            # never left its predicted start (< 1 px) confirm any prediction
            # on degenerate texture; they feed the pose solve but not the
            # health gate (the reference's staged step counts them)
            n2 = n2 - torch.sum((of_innov < 1.0) & (res2.obs_mp >= 0))
        n2 = int(n2)
        if cfg.use_lidar and (not staged_step or (
                n2 >= min_ok and bool(self.lidar_map.valid.any()))):
            # the refinement's inlier count replaces the health count
            res2 = self._lidar_refine(frame, ms2, res2, timestamp)
            n2 = int(res2.n_inliers)
        vi = None
        if vi_on and n2 >= min_ok:
            # the VI refinement, taken when it keeps max(min_inliers_ok,
            # n2 / 2) inliers; otherwise the visual pose stands and the VI
            # prior chain restarts at the next KF-anchored state
            rot_v, t_v, obs_v, n_vi, accept, body, marg = IN.refine_frame(
                mode, ms2, frame,
                res2._replace(n_inliers=torch.tensor(n2, device=self.device)),
                imu.body, pred_body, p_dev, self._vi_prior, imu.r_cb,
                imu.t_cb, imu.bias_on_device(), self.tcfg, min_ok)
            bias = torch.cat([body.bg, body.ba])
            pkt = torch.cat([n_vi.reshape(1).float(),
                             accept.reshape(1).float(), bias]).cpu().numpy()
            if bool(pkt[1]):
                self.n_vi_accepted += 1
                res2, n2 = T.TrackResult(rot_v, t_v, obs_v, n_vi), int(pkt[0])
                vi = (body, marg, pkt[2:8], bias)
            else:
                self._vi_prior = None
        self.inlier_log.append((round(timestamp, 4), n1, n2))
        if len(self.inlier_log) > 4096:
            del self.inlier_log[:2048]
        if cfg.record_reproj_err:
            for log, r, n in ((self.f2f_reproj, res, n1),
                              (self.f2m_reproj, res2, n2)):
                e = T.mean_reproj_error(self.ms, frame, r.obs_mp, r.rot, r.t,
                                        self.tcfg)
                log.append((timestamp, float(e), n))

        if n2 >= min_ok:
            self.state = TrackingState.OK
            self.lost_since = None
            self._carried_streak = 0
            self.ms = ms2
            self._set_pose(res2.rot, res2.t, last_rot, last_t)
            self.last_obs_mp = res2.obs_mp
            if imu is not None:
                self._update_body_state(p_frame, vi)
            self.frames_since_kf += 1
            self._kf_watchdog(timestamp)
            twc = None
            if self._need_new_keyframe(n2, timestamp):
                if not staged_run:
                    # the reference's frame step records the tracked pose
                    # against the reference KF before the KF's mapping
                    twc = self._record_pose(timestamp)
                self._insert_keyframe(frame, timestamp, res2, n2)
            return frame, twc
        if icp_ok is not None and bool(icp_ok):
            # ICP-carried: the registered pose is the track; the map and
            # the visual bindings stay as they were
            self.state = TrackingState.OK
            self.lost_since = None
            self._carried_streak += 1
            self.n_icp_carried += 1
            self.frames_since_kf += 1
            self._set_pose(pr, pt, last_rot, last_t)
            if imu is not None and imu.initialized and imu.body is not None:
                # the reference's staged step: the body at the registered
                # pose, at rest
                imu.body = imu.body_from_cam(pr, pt)
            if not staged_run and timestamp - self._last_kf_time >= 0.5:
                no_obs = torch.full_like(res.obs_mp, M.NO_MP)
                self._insert_keyframe(frame, timestamp,
                                      T.TrackResult(pr, pt, no_obs, 0), 0,
                                      fused_kf=True)
            self._kf_watchdog(timestamp)
            return frame, None
        self.n_lost += 1
        self.has_vel = False
        if self.state == TrackingState.OK:
            self.state = TrackingState.RECENTLY_LOST
            self.lost_since = timestamp
        if (self.state == TrackingState.RECENTLY_LOST and imu is not None
                and imu.initialized and cfg.insert_kfs_when_lost
                and timestamp - self._last_kf_time >= 0.5):
            # InsertKFsWhenLost: a KF at the IMU prediction bridges the gap
            # (the reference's staged step keeps the frame's bindings)
            self.cur_rot, self.cur_t = pr, pt
            if imu.body is not None:
                imu.body = imu.body_from_cam(pr, pt)
            self._insert_keyframe(frame, timestamp, T.TrackResult(
                pr, pt, res2.obs_mp, n2), n2)
        if (self.state == TrackingState.RECENTLY_LOST
                and self._relocalize(frame)):
            self.state = TrackingState.OK
            self.lost_since = None
            return frame, None
        if self.state == TrackingState.RECENTLY_LOST and (
                timestamp - self.lost_since > self.cfg.time_recently_lost):
            self.state = TrackingState.LOST
            self._reset_or_new_map()
        return frame, None

    def _update_body_state(self, p_frame: Optional[pre.Preintegrated], vi):
        """The body state after a tracked staged frame: the accepted VI
        state with its bias (its marginal the next frame's prior), else the
        tracked pose with the finite-difference velocity over the frame's
        gap (at rest without samples or a previous body state)."""
        imu = self.imu
        if vi is not None:
            body, marg, bias_host, bias_dev = vi
            imu.body = body
            imu.set_bias(bias_host, bias_dev)
            self._vi_prior = marg
            return
        v = None
        if imu.body is not None and p_frame is not None:
            dt = float(p_frame.dt)
            if dt > 1e-4:
                b_new = imu.body_from_cam(self.cur_rot, self.cur_t)
                v = (b_new.p - imu.body.p) / dt
        imu.body = imu.body_from_cam(self.cur_rot, self.cur_t, v=v)

    def _track_fused(self, images, imu_in, timestamp: float):
        """One frame through pipeline/fused.frame_step (the reference's
        _track_fused), then the host decisions from its packet, read once,
        as the reference's _process_pending takes them with pkt_max_pending
        0: the inlier log, the trajectory, VI acceptance and the prior
        chain, the bias, the KF policy, the ICP-carried streak, a recovered
        pose, RECENTLY_LOST/LOST and InsertKFsWhenLost. `imu_mode`: "off"
        without samples, "raw" until the IMU is initialized, then "kf" (VI
        against the last KF-anchored state) or "prior" (joint with the last
        frame's state under its marginal). A failed frame without a
        vocabulary is re-run through the staged step: without an IMU from
        the state before it, with one from the adopted outputs (see the
        module docstring). The deferred KF results are applied after the
        outputs are adopted, before the frame's decisions; a tracked frame
        steps the global BA after its KF decision. Returns the frame with
        its OF slots filled and the recorded Twc."""
        cfg, imu = self.cfg, self.imu
        if imu is None or imu_in is None:
            mode = "off"
        elif not imu.initialized or imu.body is None:
            mode = "raw"
        else:
            mode = "kf" if self._vi_prior is None else "prior"
        if imu is not None:
            self.imu_modes[mode] = self.imu_modes.get(mode, 0) + 1
        kf_modes = mode in ("kf", "prior")
        p_host = p_frame = None
        if mode != "off":
            p_host = imu.preintegrate_frame(*imu_in, timestamp)
            p_frame = pre.to_device(p_host, self.device)
        recovery = self._fused_mode() and (
            self.state == TrackingState.RECENTLY_LOST
            or self._carried_streak >= 30)
        args, kw = self._fused_inputs(images, mode, p_frame, recovery)
        out = FU.frame_step(*args, **kw)
        pkt = self._read_packet(out.host_pkt)
        n1, n2, n_vi = int(pkt[0]), int(pkt[1]), int(pkt[2])
        vi_ok = kf_modes and pkt[3] > 0.5
        aux = float(pkt[FU.PKT_AUX])
        n_final = n_vi if vi_ok else n2
        ok = n_final >= cfg.min_inliers_ok
        self.inlier_log.append((round(timestamp, 4), n1, n2))
        if len(self.inlier_log) > 4096:
            del self.inlier_log[:2048]
        rerun = not ok and aux < 0.5 and not self._fused_mode()
        if rerun and imu is None:
            # the reference re-runs the failed frame through its staged
            # step, from the state before it
            self.n_staged_reruns += 1
            self._drain_deferred()
            return self._track_frame(out.frame, timestamp)
        self._count_fused(out, timestamp)
        ref, gen = self.ref_kf, self._kf_gen.get(self.ref_kf)
        # the step's outputs are the tracking state (a failed frame's hold
        # or dead reckoning, a recovered pose, its motion model)
        self.ms = out.ms
        self.cur_rot, self.cur_t = out.rot, out.t
        self.last_obs_mp = out.obs_mp
        self.vel = (out.vel_rot, out.vel_t)
        self.has_vel = True
        if kf_modes:
            imu.body = out.body
            imu.set_bias(pkt[28:34], out.bias_out)
            self._vi_prior = out.marg
        self._drain_deferred()
        if rerun:
            # with the IMU the reference re-runs the failed frame through
            # its staged step from the outputs it adopted: the VI state and
            # prior cleared, the bias the frame preintegration's, the body
            # the dead-reckoned prediction, which the staged step predicts
            # over the same gap once more, the frame its own last frame and
            # its time the last time (ROADMAP.md Queue 3)
            self.n_staged_reruns += 1
            self._vi_prior = None
            if kf_modes:
                imu.bias = p_host.bias
            self.last_levels = out.frame.feat.level
            self.last_time = timestamp
            if cfg.use_of or cfg.use_icp:
                self.last_frame = out.frame
            return self._track_frame(out.frame, timestamp, p_host,
                                     staged=True)
        twc = np.eye(4)
        twc[:3, :4] = pkt[4:16].reshape(3, 4)
        trel = pkt[16:28].reshape(3, 4).astype(np.float64)
        if ok:
            self.state = TrackingState.OK
            self.lost_since = None
            self._carried_streak = 0
            if kf_modes and not vi_ok:
                self._vi_prior = None
            self.n_vi_accepted += int(vi_ok)
            self.frames_since_kf += 1
            self._kf_watchdog(timestamp)
            # recorded against the reference KF before the KF's mapping
            self._traj.append((timestamp, twc, ref, gen, trel))
            if self._need_new_keyframe(n_final, timestamp):
                self._insert_keyframe(out.frame, timestamp, T.TrackResult(
                    out.rot, out.t, out.obs_mp, n2), n2)
            # the global BA's micro-step: on a tracked fused frame, after
            # its KF decision
            if (self._gba is not None and self._gba.active
                    and self._gba.step()):
                self._finish_gba()
            return out.frame, twc
        if aux >= 2.0:
            # recovered in the step (the re-search or the relocalization):
            # the matched KF becomes the reference, the motion model is
            # identity, the pose is recorded without a reference KF
            cand = int(round(aux)) - 2
            self.state = TrackingState.OK
            self.lost_since = None
            self._carried_streak = 0
            self.frames_since_kf += 1
            self._vi_prior = None
            if cand in self._kf_gen and bool(self.ms.kf_valid[cand]):
                self.ref_kf = cand
            self.local_masks = None
            self.n_recovered += 1
            self.n_reloc += int(pkt[FU.PKT_RELOC] > 0.5)
            self._traj.append((timestamp, twc))
            return out.frame, twc
        if aux > 0.5:
            # ICP-carried: the registered pose is the track and the motion
            # model learns its delta; the map and the visual bindings stay,
            # the body state stays dead-reckoned and the VI marginal is kept
            # (the reference's fused step); a KF without bindings every 0.5 s
            self.state = TrackingState.OK
            self.lost_since = None
            self._carried_streak += 1
            self.n_icp_carried += 1
            self.frames_since_kf += 1
            self._traj.append((timestamp, twc, ref, gen, trel))
            if timestamp - self._last_kf_time >= 0.5:
                no_obs = torch.full_like(out.obs_mp, M.NO_MP)
                self._insert_keyframe(out.frame, timestamp, T.TrackResult(
                    out.rot, out.t, no_obs, 0), 0, fused_kf=True)
            self._kf_watchdog(timestamp)
            return out.frame, twc
        # a lost frame: with the IMU it dead-reckons the prediction, without
        # it holds the last pose; the motion model and the bindings stay
        self.n_lost += 1
        self._vi_prior = None
        if self.state == TrackingState.OK:
            self.state = TrackingState.RECENTLY_LOST
            self.lost_since = timestamp
        self._lost_stamps.add(round(timestamp, 6))
        self._traj.append((timestamp, twc))
        if (cfg.insert_kfs_when_lost and imu is not None and imu.initialized
                and timestamp - self._last_kf_time >= 0.5):
            # InsertKFsWhenLost: KFs from the dead-reckoned pose bridge the
            # gap with depth-created points; no visual bindings carry over
            no_obs = torch.full_like(out.obs_mp, M.NO_MP)
            self._insert_keyframe(out.frame, timestamp, T.TrackResult(
                out.rot, out.t, no_obs, 0), 0, fused_kf=True)
        if (self.lost_since is not None
                and timestamp - self.lost_since > cfg.time_recently_lost):
            self.state = TrackingState.LOST
            self._reset_or_new_map()
        return out.frame, twc

    def _fused_inputs(self, images, mode: str,
                      p_frame: Optional[pre.Preintegrated], recovery: bool):
        """frame_step's (args, kwargs) for the next frame from the tracking
        state: `images` on the device, the `imu_mode`, the frame gap's
        preintegration on the device, and whether it runs the recovery
        variant."""
        cfg, imu = self.cfg, self.imu
        kf_modes = mode in ("kf", "prior")
        if self.local_masks is None:
            self.local_masks = M.local_window(
                self.ms, self.ref_kf, self.tcfg.local_window,
                self.tcfg.lm_max_candidates)
        chain = cfg.use_of or cfg.use_icp
        args = (*images, self.ms, self.last_obs_mp, self.last_levels,
                self.vel[0], self.vel[1], self.has_vel, self.cur_rot,
                self.cur_t, self.ref_kf, self.local_masks, p_frame,
                imu.body if kf_modes else None,
                imu.bias_on_device() if kf_modes else None,
                self._vi_prior if mode == "prior" else None,
                imu.r_cb if kf_modes else None,
                imu.t_cb if kf_modes else None,
                self.tcfg, cfg.frame, mode, cfg.min_inliers_ok)
        kw = dict(device=self.device,
                  last_frame=self.last_frame if chain else None,
                  use_of=cfg.use_of, use_icp=cfg.use_icp,
                  icp_method=cfg.icp_method,
                  icp_min_inliers=cfg.icp_min_inliers,
                  n_of_slots=cfg.frame.n_of_slots, gen=self._gen,
                  use_lidar=cfg.use_lidar, lidar_map=self.lidar_map,
                  lidar_cfg=self._lidar_cfg, with_recovery=recovery,
                  relocalize=self._reloc_attempt if recovery else None)
        return args, kw

    def _fused_mode(self) -> bool:
        """The reference's default recovery (see the module docstring)."""
        return self.vocab is not None and not self.cfg.record_reproj_err

    def _read_packet(self, pkt: torch.Tensor) -> np.ndarray:
        """The frame step's packet on the host: one copy into a pinned
        buffer and one event sync on a CUDA device. The copy and the event
        go on the packet's device's current stream, which need not be the
        current device's."""
        if not pkt.is_cuda:
            return pkt.numpy().copy()
        if self._pkt_host is None:
            self._pkt_host = torch.empty(pkt.shape, dtype=pkt.dtype,
                                         pin_memory=True)
            self._pkt_event = torch.cuda.Event()
        with torch.cuda.device(pkt.device):
            self._pkt_host.copy_(pkt, non_blocking=True)
            self._pkt_event.record(torch.cuda.current_stream(pkt.device))
        self._pkt_event.synchronize()
        return self._pkt_host.numpy().copy()

    def _count_fused(self, out: FU.FusedOut, timestamp: float):
        """The device-side counters of a fused frame: OF points appended,
        ICP predictions accepted, valid plane factors."""
        if out.of_counts is not None:
            self._of_last = out.of_counts
            self._of_total = self._of_total + out.of_counts
        if out.icp_ok is not None:
            self._icp_accepted = self._icp_accepted + out.icp_ok
        if out.n_planes is not None:
            self._plane_log.append((round(timestamp, 4), out.n_planes))
            if len(self._plane_log) > 4096:
                del self._plane_log[:2048]

    def _reloc_attempt(self, frame: FrameData):
        """One reloc_core call on the active map (one K4 launch on the
        card): (n_inl, rot, t, obs_mp, cand)."""
        return R.reloc_core(
            self.vocab, self.reloc_db, self.ms, frame, self._reloc_gen,
            self.tcfg, self.cfg.frame.orb.width, self.cfg.frame.orb.height)

    def _relocalize(self, frame: FrameData) -> bool:
        """Tracking::Relocalization over the top-3 BoW candidates of the
        active map (the staged mode); adopts the pose when pose-only GN
        keeps min_inliers_ok inliers (with an IMU, the body state at rest at
        the new pose, and the pending samples dropped)."""
        if self.vocab is None:
            return False
        n_inl, rot, t, obs2, _ = self._reloc_attempt(frame)
        if int(n_inl) < self.cfg.min_inliers_ok:
            return False
        self.cur_rot, self.cur_t = rot, t
        self.last_obs_mp = obs2
        self.n_reloc += 1
        if self.imu is not None:
            self.imu.body = self.imu.body_from_cam(rot, t)
            self.imu.pending = None
        return True

    def _kf_watchdog(self, timestamp: float):
        """Count and warn, at most every 10 s, when no keyframe has landed
        for more than 10 s while tracking holds (never in localization
        mode)."""
        if self._localization_only:
            return
        if (timestamp - self._last_kf_time > 10.0
                and timestamp - self._last_stall_warn > 10.0):
            self._last_stall_warn = timestamp
            self.kf_stall_warnings += 1
            warnings.warn(
                f"KF-stall watchdog: no keyframe for "
                f"{timestamp - self._last_kf_time:.1f}s while tracking OK "
                f"(frames_since_kf={self.frames_since_kf}, "
                f"carried_streak={self._carried_streak})")

    def _set_pose(self, rot, t, last_rot, last_t):
        """Adopt Tcw and learn the motion model Tcl = Tcw Tlw^-1, its
        translation clamped to 0.5 m."""
        self.cur_rot, self.cur_t = rot, t
        lri, lti = lie.se3_inverse(last_rot, last_t)
        vr, vt = lie.se3_compose(rot, t, lri, lti)
        vt = vt * torch.clamp(0.5 / torch.clamp_min(
            torch.linalg.norm(vt), 1e-9), max=1.0)
        self.vel = (vr, vt)
        self.has_vel = True

    def _of_stage(self, frame: FrameData, pred_rot, pred_t):
        """The dual-stream optical flow from the predicted pose into the
        frame's OF slots, with use_of and a previous frame: (the frame,
        map-point ids bound to its slots, per-slot innovation) or (the
        frame, None, None)."""
        cfg = self.cfg
        if not (cfg.use_of and self.last_frame is not None
                and cfg.frame.n_of_slots > 0):
            return frame, None, None
        frame, extra_obs, n3d, n2d, of_innov = OF.of_dual_stream(
            self.ms, self.last_frame, frame, self.last_obs_mp, pred_rot,
            pred_t, self._gen, self.tcfg, OF.OFConfig(), cfg.frame.n_of_slots)
        self._of_last = torch.stack([n3d, n2d])
        self._of_total = self._of_total + self._of_last
        return frame, extra_obs, of_innov

    def _icp_predict(self, frame: FrameData, pred_rot, pred_t):
        """GICP/NDT registration of the frame's depth cloud against the last
        frame's as the pose predictor (PredictStateICP). Accepted when it
        converged, has icp_min_inliers inliers and a plausible motion;
        returns (Tcw prediction, accepted flag), both on the device."""
        lf = self.last_frame
        # init: T_lc = T_lw T_cw_pred^-1
        pri, pti = lie.se3_inverse(pred_rot, pred_t)
        r0, t0 = lie.se3_compose(self.cur_rot, self.cur_t, pri, pti)
        register = (G.ndt_register if self.cfg.icp_method == "ndt"
                    else G.gicp_register)
        reg = register(frame.cloud, frame.cloud_valid, lf.cloud,
                       lf.cloud_valid, init_rot=r0, init_t=t0)
        # plausibility: a degenerate (planar) cloud "converges" onto any
        # in-plane init; no camera here moves 0.5 m or ~20 deg per frame
        dr_cos = 0.5 * (torch.trace(reg.rot) - 1.0)
        plaus = (torch.linalg.norm(reg.t) < 0.5) & (dr_cos > 0.94)
        ok = (reg.converged & (reg.n_inliers >= self.cfg.icp_min_inliers)
              & plaus)
        self._icp_accepted = self._icp_accepted + ok
        # T_cw = T_lc^-1 T_lw
        rri, rti = lie.se3_inverse(reg.rot, reg.t)
        r_icp, t_icp = lie.se3_compose(rri, rti, self.cur_rot, self.cur_t)
        return (torch.where(ok, r_icp, pred_rot),
                torch.where(ok, t_icp, pred_t), ok)

    def _need_new_keyframe(self, n_inliers: int,
                           timestamp: Optional[float] = None) -> bool:
        """NeedNewKeyFrame essentials; with an IMU a KF at least every
        0.5 s keeps the preintegration segments short. None in localization
        mode."""
        if self._localization_only:
            return False
        if (self.imu is not None and self.frames_since_kf >= 1
                and timestamp - self._last_kf_time >= 0.5):
            return True
        ref = max(self.ref_kf_inliers, 1)
        if n_inliers < 0.35 * ref and self.frames_since_kf >= 1:
            return True   # tracking cliff: insert regardless of cadence
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= self.cfg.kf_max_interval:
            return True
        return n_inliers < self.cfg.kf_tracked_ratio * ref

    def _insert_keyframe(self, frame: FrameData, timestamp: float,
                         res: T.TrackResult, n_inliers: int,
                         fused_kf: bool = False):
        """A KF through the reference's fused KF step (one mapping step, no
        host read), or its staged KF step until the IMU is initialized and,
        with use_lidar or without local_ba_every_kf, for the KF of a tracked
        frame (`fused_kf` False: the ICP-carried and lost frames' KFs take
        the fused step)."""
        if ((self.imu is not None and not self.imu.initialized)
                or ((self.cfg.use_lidar or not self.cfg.local_ba_every_kf)
                    and not fused_kf)
                or self.cfg.sensor == "mono"):
            return self._insert_keyframe_staged(frame, timestamp, res,
                                                n_inliers)
        with self.timers.time("New_KF"):
            self._insert_keyframe_fused(frame, timestamp, res, n_inliers)

    def _insert_keyframe_fused(self, frame: FrameData, timestamp: float,
                               res: T.TrackResult, n_inliers: int):
        """The reference's fused KF step (its _insert_keyframe_fused): the
        slot from the host mirror, the lazy inter-KF GICP (use_icp), the VI
        window staged through pinned memory (with the IMU), one mapping
        step, BA's correction of the KF folded into the tracked pose, the
        mirror updated; the step's culled slot and, with loop closing, the
        KF's place recognition are copied to the host without a wait and
        applied `fused_lag` processed frames later (_drain_deferred).
        Reads the device only when the mirror is dirty."""
        slot = self._fused_kf_slot()
        if self.cfg.use_icp:
            self._register_kf_icp(slot, frame, res.rot, res.t,
                                  self._icp_prev(), lazy=True)
        vi = self._vi_window_for_kf(slot, timestamp) if self.imu else None
        ms, new_obs, masks, kf_rot, kf_t, culled, _ = LM.mapping_step(
            self.ms, frame, res.rot, res.t, self._t_rel(timestamp),
            res.obs_mp, self.ref_kf, slot, self.tcfg, self.mcfg, vi=vi)
        self.ms = ms
        self.local_masks = masks
        # the tracked pose is the KF's pose before BA: fold BA's correction
        # of the KF into it (cur o old^-1 o new); the frame-to-frame motion
        # model is invariant to this right-side world correction. The
        # reference's frame step keeps the frame's tracked bindings (the
        # KF's new close points join through the local map); with
        # record_reproj_err the RGB-D path tracks on from the KF's bindings
        # after mapping, the IMU's staged frames from the frame's
        ri, ti = lie.se3_inverse(res.rot, res.t)
        dr, dt = lie.se3_compose(ri, ti, kf_rot, kf_t)
        self.cur_rot, self.cur_t = lie.se3_compose(self.cur_rot, self.cur_t,
                                                   dr, dt)
        if self.cfg.record_reproj_err and self.imu is None:
            self.last_obs_mp = new_obs
        if self.cfg.use_lidar:
            self._insert_kf_cloud(slot, frame, kf_rot, kf_t, lazy=True)
        self._kf_prev_h[slot] = self.ref_kf
        self.ref_kf = slot
        self.ref_kf_inliers = n_inliers
        self.frames_since_kf = 0
        self._last_kf_time = timestamp
        self._vi_prior = None
        self._gen_counter += 1
        self._kf_gen[slot] = self._gen_counter
        self._kf_valid_h[slot] = True
        self._kf_map_h[slot] = self._active_map_h
        if vi is not None:
            # the next frame tracks against the map-anchored KF state
            self._rederive_body()
        lag = max(self.cfg.fused_lag, 1)
        self._deferred.append(dict(culled=HostCopy(culled.reshape(1)),
                                   countdown=lag))
        if self.loop_closer is None:
            self._db_insert_kf(slot)
            return
        self._deferred.append(dict(
            loop_scalars=self.loop_closer.begin_detect(self.ms, slot),
            kf=slot, frame=self.n_frames, countdown=lag))

    def _drain_deferred(self, force: bool = False):
        """Apply the deferred KF results whose countdown ran out (every one
        with `force`): a cull's bookkeeping (_on_kf_culled, the slot freed
        in the mirror) and a loop detection's matured candidate
        (_handle_loop_scalars). Called once per fused frame after its
        outputs are adopted, and forced where the reference flushes its
        pipeline: the staged entry, trajectory, map_stats, save_atlas,
        save_session, shutdown."""
        keep = []
        for ent in self._deferred:
            ent["countdown"] -= 1
            if ent["countdown"] > 0 and not force:
                keep.append(ent)
                continue
            if "culled" in ent:
                culled = int(np.asarray(ent["culled"])[0])
                if culled >= 0:
                    self._on_kf_culled(culled)
                    self._kf_valid_h[culled] = False
            else:
                self._handle_loop_scalars(ent)
        self._deferred = keep

    def _handle_loop_scalars(self, ent):
        """A deferred loop detection: for a matured candidate, Sim3
        verification and the correction (loop_closing.complete_candidate);
        on a closed loop the reference KF's correction is carried onto the
        current pose (the motion model dropped, the body re-derived), the
        global BA restarted and the mirror resynced at the next KF."""
        lc = self.loop_closer
        best = lc.matured_candidate(np.asarray(ent["loop_scalars"]))
        if best is None:
            return
        self.n_loop_matured += 1
        r_old, t_old = self.ms.kf_rot[self.ref_kf], self.ms.kf_t[self.ref_kf]
        self.ms, found = lc.complete_candidate(
            self.ms, ent["kf"], best, kf_clouds=self._kf_clouds or None,
            inertial=self.imu is not None and self.imu.initialized)
        if not found:
            return
        self.loop_events.append((ent["frame"], self.n_frames))
        self._mirror_dirty = True
        self._carry_ref_correction(r_old, t_old)
        if self._gba is not None and self.cfg.loop.async_global_ba:
            self._gba.abort()
            self._gba.start(self.ms)
        self.local_masks = None

    def _carry_ref_correction(self, r_ref_old, t_ref_old):
        """The map moved under the tracker: T_cur' = T_cur T_ref_old^-1
        T_ref_new with the reference KF's old and new poses."""
        ri, ti = lie.se3_inverse(r_ref_old, t_ref_old)
        dr, dt = lie.se3_compose(ri, ti, self.ms.kf_rot[self.ref_kf],
                                 self.ms.kf_t[self.ref_kf])
        self.cur_rot, self.cur_t = lie.se3_compose(self.cur_rot, self.cur_t,
                                                   dr, dt)
        self.has_vel = False
        self._rederive_body()

    def _rederive_body(self):
        """The body state at the current pose, its velocity kept (after a
        map correction moved the pose)."""
        if self.imu is not None and self.imu.body is not None:
            self.imu.body = self.imu.body_from_cam(self.cur_rot, self.cur_t,
                                                   v=self.imu.body.v)

    def _vi_window(self, slots, kw: int) -> LM.VIWindow:
        """A VI-BA window over `slots` (oldest first), end-padded to kw with
        the out-of-range slot k_max; with use_icp its EdgeICP factors. The
        host arrays go to the device through pinned memory, unwaited."""
        imu = self.imu
        slots_p = list(slots) + [self.cfg.k_max] * (kw - len(slots))
        return LM.VIWindow(
            slots=stage(np.asarray(slots_p, np.int64), self.device),
            slot_valid=torch.arange(kw, device=self.device) < len(slots),
            segs=imu.build_segments(slots_p), r_cb=imu.r_cb, t_cb=imu.t_cb,
            walk_info=imu.walk_info_dev,
            icp=self._icp_factors(slots_p, kw) if self.cfg.use_icp else None)

    def _viba_width(self, timestamp: float):
        """(the VI-BA window of a KF, whether this KF is a VIBA1 or VIBA2
        transition): 8, or 16 at the staged refinements VIBA1 and VIBA2
        (the first KF past 5 s and 10 s after the IMU initialization)."""
        imu, t = self.imu, self._t_rel(timestamp)
        if imu.init_time is not None and not imu.viba1_done \
                and t - imu.init_time > 5.0:
            imu.viba1_done = True
            return 16, True
        if imu.init_time is not None and not imu.viba2_done \
                and t - imu.init_time > 10.0:
            imu.viba2_done = True
            return 16, True
        return 8, False

    def _vi_window_for_kf(self, slot: int, timestamp: float):
        """Bind the pending IMU segment to the new KF and return (velocity,
        bias, VI-BA window) for its mapping step, or None (local BA) while
        the window holds fewer than 3 KFs."""
        imu = self.imu
        imu.on_keyframe(slot, upto_ts=timestamp)
        kw, _ = self._viba_width(timestamp)
        slots = imu.contiguous_window(kw)
        if len(slots) < 3:
            return None
        vel = (imu.body.v if imu.body is not None
               else torch.zeros(3, device=self.device))
        return vel, imu.bias_on_device(), self._vi_window(slots, kw)

    def _insert_keyframe_staged(self, frame: FrameData, timestamp: float,
                                res: T.TrackResult, n_inliers: int):
        """The reference's staged KF step (its KF step until the IMU is
        initialized, and for every tracked frame's KF with use_lidar): KF
        insertion, the host-gated inter-KF registration (use_icp), the IMU
        initialization attempt (on success VI-BA over the init window, kw
        10) or the VI state stamped on the KF, with a monocular camera the
        triangulation of new points and the ScaleRefinement cadence, local
        BA (VI-BA once the IMU is initialized; a monocular VIBA1 or VIBA2
        re-runs the initialization first; without local_ba_every_kf none,
        and the tracked pose and motion model stay), duplicate fusion, point
        statistics, point and KF culling, the cloud into the local and
        global maps (use_lidar) at the optimized KF pose, loop detection;
        tracking goes on from the KF's pose and its live bindings, without
        the motion model."""
        imu = self.imu
        self._mirror_dirty = True
        slot = self._free_kf_slot()
        with self.timers.time("New_KF"):
            self.ms, _ = T.create_keyframe(
                self.ms, frame, res.rot, res.t, self._t_rel(timestamp),
                res.obs_mp, self.ref_kf, slot, self.tcfg)
        self._kf_prev_h[slot] = self.ref_kf
        self.ref_kf = slot
        self.ref_kf_inliers = n_inliers
        self.frames_since_kf = 0
        self._last_kf_time = timestamp
        self._gen_counter += 1
        self._kf_gen[slot] = self._gen_counter
        self._vi_prior = None
        if self.cfg.use_icp and bool(frame.cloud_valid.any()):
            self._register_kf_icp(slot, frame, res.rot, res.t,
                                  self._icp_prev(), lazy=False)
        if imu is not None:
            imu.on_keyframe(slot, upto_ts=timestamp)
            if not imu.initialized:
                self._try_imu_init(slot, timestamp)
            elif imu.body is not None:
                self.ms = self.ms._replace(
                    kf_vel=M._set_row(self.ms.kf_vel, slot, imu.body.v),
                    kf_bias=M._set_row(self.ms.kf_bias, slot,
                                       imu.bias_on_device()))
        mono = self.cfg.sensor == "mono"
        if mono:
            # CreateNewMapPoints: monocular points come from triangulation
            self.ms, n_tri = LM.triangulate_new_points(self.ms, slot,
                                                       self.mcfg)
            self.n_triangulated.append(n_tri)
            if len(self.n_triangulated) > 4096:
                del self.n_triangulated[:2048]
            t_rel = self._t_rel(timestamp)
            if (imu is not None and imu.initialized
                    and imu.init_time is not None
                    and t_rel - imu.init_time > 5.0
                    and t_rel - self._last_scale_ref > 10.0):
                # ScaleRefinement: re-pin the metric scale against the IMU
                self._last_scale_ref = t_rel
                self.ms = imu.scale_refinement(self.ms)
                self._reanchor_on_imu_transform(slot, imu.body is not None)
        if self.cfg.local_ba_every_kf:
            self._staged_ba(slot, timestamp, mono)
        self.ms = LM.fuse_duplicates(self.ms, slot, self.mcfg)
        self.ms = LM.refresh_point_stats(self.ms, slot)
        self.ms = M.cull_map_points(self.ms)
        self.ms, culled = LM.keyframe_culling(self.ms, slot)
        culled_i = int(culled)
        if culled_i >= 0:
            self._on_kf_culled(culled_i)
        if self.cfg.use_lidar:
            self._insert_kf_cloud(slot, frame, self.ms.kf_rot[slot],
                                  self.ms.kf_t[slot], lazy=False)
        if self.loop_closer is not None:
            self.ms, found = self.loop_closer.on_keyframe(
                self.ms, slot, kf_clouds=self._kf_clouds or None,
                inertial=imu is not None and imu.initialized)
            if found:
                self.cur_rot = self.ms.kf_rot[slot]
                self.cur_t = self.ms.kf_t[slot]
                self.has_vel = False
                self._rederive_body()
                if self._gba is not None and self.cfg.loop.async_global_ba:
                    self._gba.abort()
                    self._gba.start(self.ms)
        obs = self.ms.kf_obs_mp[slot]
        self.last_obs_mp = torch.where(
            (obs >= 0) & self.ms.mp_valid[torch.clamp_min(obs, 0).long()],
            obs, M.NO_MP)
        self.local_masks = None

    def _staged_ba(self, slot: int, timestamp: float, mono: bool):
        """The staged KF step's local BA, or VI-BA over the temporal window
        once the IMU is initialized (a monocular VIBA1 or VIBA2 re-runs the
        initialization first); then the tracked state re-anchors on the
        optimized KF."""
        imu = self.imu
        with self.timers.time("LBA"):
            slots = []
            if (imu is not None and imu.initialized
                    and len(imu.kf_order) >= 4):
                kw, transition = self._viba_width(timestamp)
                if transition and mono:
                    # VIBA1 / VIBA2 re-run InitializeIMU over the grown
                    # chain before the wide VI-BA
                    self.ms, did = imu.reinitialize(self.ms, scale_free=True)
                    if did:
                        self._reanchor_on_imu_transform(slot, True)
                slots = imu.contiguous_window(kw)
            if len(slots) >= 3:
                self.ms, _ = LM.vi_ba_step(self.ms, self._vi_window(slots, kw),
                                           self.mcfg)
            else:
                self.ms, _ = LM.local_ba_step(self.ms, slot, self.mcfg)
        # BA moved the map: re-anchor on the optimized KF
        self.cur_rot, self.cur_t = self.ms.kf_rot[slot], self.ms.kf_t[slot]
        self.has_vel = False
        if imu is not None and imu.initialized:
            self._rederive_body()

    def _try_imu_init(self, slot: int, timestamp: float):
        """The IMU initialization attempt at a new KF; on success VI-BA over
        the init window (kw 10) and the tracked state re-anchored on the
        rotated and scaled map."""
        imu = self.imu
        self.ms, did = imu.try_initialize(
            self.ms, scale_free=self.cfg.sensor == "mono")
        if not did:
            return
        imu.init_time = self._t_rel(timestamp)
        self._consume_imu_transform()
        slots0 = imu.contiguous_window(10)
        if len(slots0) >= 3:
            self.ms, _ = LM.vi_ba_step(
                self.ms, self._vi_window(slots0, 10), self.mcfg)
        self.cur_rot, self.cur_t = self.ms.kf_rot[slot], self.ms.kf_t[slot]
        imu.body = imu.body_from_cam(self.cur_rot, self.cur_t,
                                     v=self.ms.kf_vel[slot])
        self.has_vel = False

    def _reanchor_on_imu_transform(self, slot: int, with_body: bool):
        """After a rescaling IMU step (ScaleRefinement, a re-run
        initialization): fold its map transform into the trajectory and
        re-anchor the tracked state on KF `slot`, the body state (with
        `with_body`) at its pose and velocity."""
        self._consume_imu_transform()
        self.cur_rot, self.cur_t = self.ms.kf_rot[slot], self.ms.kf_t[slot]
        self.has_vel = False
        if with_body:
            self.imu.body = self.imu.body_from_cam(
                self.cur_rot, self.cur_t, v=self.ms.kf_vel[slot])

    def _icp_prev(self) -> Optional[int]:
        """The KF the next inter-KF registration pairs with: the newest KF
        of the IMU's order, else the last registered KF."""
        if self.imu is not None and self.imu.kf_order:
            return self.imu.kf_order[-1]
        return self._last_kf_slot

    def _register_kf_icp(self, slot: int, frame: FrameData, rot, t,
                         prev: Optional[int], lazy: bool):
        """Store the KF's cloud and register it by GICP against the cloud of
        KF `prev`, from their current poses, as an EdgeICP measurement
        T_cw[slot] T_cw[prev]^-1. The gate (converged, >= 400 inliers, error
        < 0.01, translation within 0.1 m of the start) stays on the device
        with `lazy`; otherwise it is read and a failed registration is
        dropped. A recycled slot loses its old measurement first."""
        self._kf_icp_rel.pop(slot, None)
        # insertion order, a reused slot re-entering as the newest
        self._kf_clouds.pop(slot, None)
        self._kf_clouds[slot] = (frame.cloud, frame.cloud_valid)
        while len(self._kf_clouds) > 40:
            self._kf_clouds.pop(next(iter(self._kf_clouds)))
        self._last_kf_slot = slot
        if prev is None or prev not in self._kf_clouds or prev == slot:
            return
        pc_prev, pv_prev = self._kf_clouds[prev]
        ri, ti = lie.se3_inverse(rot, t)
        r0, t0 = lie.se3_compose(self.ms.kf_rot[prev], self.ms.kf_t[prev],
                                 ri, ti)
        reg = G.gicp_register(frame.cloud, frame.cloud_valid, pc_prev,
                              pv_prev, init_rot=r0, init_t=t0)
        gate = (reg.converged & (reg.n_inliers >= 400) & (reg.error < 0.01)
                & (torch.linalg.norm(reg.t - t0) < 0.1))
        if not lazy and not bool(gate):
            return
        rr, tr = lie.se3_inverse(reg.rot, reg.t)
        self._kf_icp_rel[slot] = (rr, tr, prev, gate)

    def _icp_factors(self, slots_p, kw: int) -> VIBA.RelPoseFactors:
        """The EdgeICP factors of a padded VI window: the measurement of
        each consecutive pair, information 1e2 where its gate passed, rows
        of zero information elsewhere."""
        dev = self.device
        rots, ts, infos, n_meas = [], [], [], 0
        for i in range(kw - 1):
            rel = self._kf_icp_rel.get(slots_p[i + 1])
            if rel is not None and rel[2] == slots_p[i]:
                n_meas += 1
                rots.append(rel[0])
                ts.append(rel[1])
                infos.append(torch.where(rel[3], 1e2, 0.0).to(dev))
            else:
                rots.append(torch.eye(3, device=dev))
                ts.append(torch.zeros(3, device=dev))
                infos.append(torch.zeros((), device=dev))
        icp = VIBA.RelPoseFactors(rot=torch.stack(rots), t=torch.stack(ts),
                                  info=torch.stack(infos))
        self._edge_icp_rows = self._edge_icp_rows + torch.stack([
            torch.full((), n_meas, dtype=torch.long, device=dev),
            (icp.info > 0).sum()])
        return icp

    def _insert_kf_cloud(self, slot: int, frame: FrameData, kf_rot, kf_t,
                         lazy: bool):
        """The KF's cloud into the sliding local map (KF slots below
        slot - window_kfs leave it) and into the global map."""
        oldest = max(slot - self._lidar_cfg.window_kfs, 0)
        self.lidar_map = LD.insert_kf_cloud(
            self.lidar_map, frame.cloud, frame.cloud_valid, kf_rot, kf_t,
            slot, oldest, self._lidar_cfg)
        add = self.global_map.add_lazy if lazy else self.global_map.add
        add(frame.cloud, frame.cloud_valid, kf_rot, kf_t)

    def _lidar_refine(self, frame: FrameData, ms: M.MapState,
                      res: T.TrackResult, timestamp: float) -> T.TrackResult:
        """Pose GN over reprojection and the point-to-plane factors of the
        frame's cloud against the local map, 2 rounds x 5 iterations; the
        bindings are cut to the inliers."""
        pl = LD.make_plane_obs(self.lidar_map, frame.cloud, frame.cloud_valid,
                               res.rot, res.t, self._lidar_cfg)
        self._plane_log.append((round(timestamp, 4), pl.valid.sum()))
        if len(self._plane_log) > 4096:
            del self._plane_log[:2048]
        return T.TrackResult(*T.pose_opt_from_obs(
            ms, frame, res.obs_mp, res.rot, res.t, self.tcfg, plane_obs=pl,
            rounds=2, iters_per_round=5))

    def _odom_predict(self, pr, pt, timestamp: float):
        """PredictStateOdom: the predicted rotation, at the last position
        moved by the mean queued camera-frame (rotated to the world) and
        world-frame velocities times the frame gap; empties the queue."""
        dt = max(timestamp - self.last_time, 0.0)
        cam_v = [v for f, v in self._odom_queue if f == "cam"]
        wld_v = [v for f, v in self._odom_queue if f == "world"]
        self._odom_queue = []
        self.n_odom_frames += 1
        rwc, twc = lie.se3_inverse(self.cur_rot, self.cur_t)
        dpos = torch.zeros(3, device=self.device)
        if cam_v:
            dpos = dpos + rwc @ (torch.as_tensor(
                np.mean(cam_v, axis=0), device=self.device) * dt)
        if wld_v:
            dpos = dpos + torch.as_tensor(
                np.mean(wld_v, axis=0), device=self.device) * dt
        r_wc_pred, _ = lie.se3_inverse(pr, pt)
        return lie.se3_inverse(r_wc_pred, twc + dpos)

    def _consume_imu_transform(self):
        """Fold the map transform of the last IMU initialization into the
        recorded trajectory (world X' = s R_gw X): absolute snapshots,
        relative entries and culled-parent links alike."""
        tr = self.imu.last_transform
        if tr is None:
            return
        self.imu.last_transform = None
        rw, s = np.asarray(tr[0], np.float64), float(tr[1])
        for i, e in enumerate(self._traj):
            m = np.asarray(e[1], np.float64).copy()
            m[:3, :3] = rw @ m[:3, :3]
            m[:3, 3] = s * (rw @ m[:3, 3])
            if len(e) == 2:
                self._traj[i] = (e[0], m)
            else:
                trel = e[4].copy()
                trel[:, 3] = s * trel[:, 3]
                self._traj[i] = (e[0], m, e[2], e[3], trel)
        for k, (prev, pgen, tcp) in list(self._culled_rel.items()):
            tcp = np.asarray(tcp, np.float64).copy()
            tcp[:, 3] = s * tcp[:, 3]
            self._culled_rel[k] = (prev, pgen, tcp)

    def _finish_gba(self):
        """Write the finished global BA back and carry the reference KF's
        correction onto the current pose when tracking."""
        r_old, t_old = self.ms.kf_rot[self.ref_kf], self.ms.kf_t[self.ref_kf]
        self.ms = self._gba.finish(self.ms)
        if self.state == TrackingState.OK:
            self._carry_ref_correction(r_old, t_old)
        self.local_masks = None

    def _on_kf_culled(self, culled: int):
        """The bookkeeping of a culled KF, from the host mirror as the
        reference keeps it: T_culled<-parent for trajectory rebasing (mTcp)
        computed on the device from the map as it stands and copied to the
        host without a wait, the culled KF's children re-parented in the
        mirror, its BoW entry erased, its IMU segment merged into its
        successor's. The mirror is built at the first cull if no KF step
        has built it yet (and then kept, as the reference keeps it)."""
        gen = self._kf_gen.get(culled)
        if gen is not None:
            # built once, as the reference builds it: a staged KF step does
            # not mark its slot valid there, so on a purely staged run a
            # parent inserted after the first cull gets no snapshot and its
            # children export as tracked (ROADMAP.md Queue 3)
            if self._kf_valid_h is None:
                self._host_slot_mirror()
            prev = self._kf_prev_h.get(culled, -1)
            if 0 <= prev < self.ms.k_max and self._kf_valid_h[prev]:
                self._culled_rel[(culled, gen)] = (
                    prev, self._kf_gen.get(prev),
                    HostCopy(_culled_rel_pose(self.ms, culled, prev)))
        pv = self._kf_prev_h.pop(culled, -1)
        for k, p in self._kf_prev_h.items():
            if p == culled:
                self._kf_prev_h[k] = pv
        if self.loop_closer is not None:
            self.loop_closer.db = DBD.erase_keyframe(self.loop_closer.db,
                                                     culled)
        elif self._reloc_db is not None:
            self._reloc_db = DBD.erase_keyframe(self._reloc_db, culled)
        imu = self.imu
        if imu is not None and culled in imu.kf_preints:
            # the culled KF's segment is merged into its successor's
            order = imu.kf_order
            if culled in order:
                pos = order.index(culled)
                nxt = order[pos + 1] if pos + 1 < len(order) else None
                if nxt in imu.kf_preints:
                    imu.kf_preints[nxt] = imu.merge_segments(
                        imu.kf_preints[culled], imu.kf_preints[nxt])
                order.remove(culled)
                imu.kf_preints.pop(culled, None)

    def _reset_or_new_map(self):
        """Atlas recovery: start a new map when the active one holds enough
        KFs (Tracking::CreateMapInAtlas), then reinitialize."""
        self._mirror_dirty = True
        ms = self.ms
        n_kfs = int((ms.kf_valid & (ms.kf_map_id == ms.active_map)).sum())
        if n_kfs >= self.cfg.min_kfs_for_new_map:
            self.ms = M.create_new_map(self.ms)
        self._restart()

    def _record_pose(self, timestamp: float,
                     with_ref: bool = True) -> np.ndarray:
        """Record the pose relative to the reference KF (or alone), with one
        device read of the current and the reference KF pose."""
        if self.state in (TrackingState.RECENTLY_LOST, TrackingState.LOST):
            self._lost_stamps.add(round(timestamp, 6))
        ref = self.ref_kf
        gen = self._kf_gen.get(ref) if with_ref else None
        both = torch.stack([
            torch.cat([self.cur_rot, self.cur_t[:, None]], 1),
            torch.cat([self.ms.kf_rot[ref], self.ms.kf_t[ref][:, None]], 1),
        ]).cpu().numpy().astype(np.float64)
        r_cw, t_cw = both[0, :, :3], both[0, :, 3]
        twc = _twc(r_cw, t_cw)
        if gen is None:
            self._traj.append((timestamp, twc))
            return twc
        r_cr = r_cw @ both[1, :, :3].T
        t_cr = t_cw - r_cr @ both[1, :, 3]
        self._traj.append((timestamp, twc, ref, gen,
                           np.concatenate([r_cr, t_cr[:, None]], 1)))
        return twc


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _culled_rel_pose(ms: M.MapState, culled: int, prev: int) -> torch.Tensor:
    """T_culled<-prev as a [3, 4] tensor on the map's device."""
    r_cp = ms.kf_rot[culled] @ ms.kf_rot[prev].T
    t_cp = ms.kf_t[culled] - r_cp @ ms.kf_t[prev]
    return torch.cat([r_cp, t_cp[:, None]], 1)


def _twc(r_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """4x4 camera-to-world from Tcw (float64)."""
    out = np.eye(4)
    out[:3, :3] = np.asarray(r_cw, np.float64).T
    out[:3, 3] = -out[:3, :3] @ np.asarray(t_cw, np.float64)
    return out
