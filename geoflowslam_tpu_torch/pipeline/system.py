"""RGB-D SLAM façade of the port (the synchronous counterpart of
geoflowslam_tpu/pipeline/system.py's RGB-D path).

Per frame, in the caller's thread, on the system's device:
  [m12 feed: pack on the host, unpack on the device] -> motion-model pose
  prediction -> build_frame -> [use_icp: GICP/NDT registration against the
  last frame as the pose predictor] -> [use_of: the dual-stream optical
  flow fills the frame's OF slots] -> track_with_motion_model ->
  track_local_map -> accept or reject (min_inliers_ok, OF confirmations
  discounted) -> NeedNewKeyFrame -> on a keyframe, one
  local_mapping.mapping_step -> trajectory record (t, T_cr, ref KF).
The OF and ICP stages follow the reference's fused frame step
(geoflowslam_tpu/pipeline/fused.py): a registration is accepted only when it
converged, has enough inliers and moved plausibly (< 0.5 m, < ~20 deg); a
frame whose visual inliers collapse while the registration held is
ICP-carried: state OK at the registered pose, the motion model learns the
registered delta, and a keyframe without bindings every 0.5 s.
The host reads the inlier counts once per stage and the pose once per frame;
there is no deferred decision ring and no reader thread: a local card needs
neither. Initialization is StereoInitialization. A KF-stall watchdog counts
(`kf_stall_warnings`) and warns when no keyframe has landed for 10 s of
tracking.

A frame whose track fails is handled in one of two modes, as the reference's
façade handles it:
* fused (the reference's default path): with a vocabulary and without
  `record_reproj_err`. The failed frame holds the last pose, keeps the
  motion model and the bindings and goes RECENTLY_LOST at once. Every later
  frame while RECENTLY_LOST, and every frame once an ICP-carried streak
  reaches 30, runs the recovery step when its track fails
  (pipeline/reloc.recover_frame: a 40 px re-search from the predicted pose,
  else relocalization, adopted at >= max(min_inliers_ok, 30) inliers): the
  matched KF becomes the reference, the motion model identity, the pose is
  recorded without a reference KF. After `time_recently_lost` the state
  goes LOST and a new Atlas map starts.
* staged: with `record_reproj_err` (which also fills `f2f_reproj` and
  `f2m_reproj`), or without a vocabulary. The failed frame retries wider
  from the last pose, then (with a vocabulary) TrackReferenceKeyFrame;
  failing that it drops the motion model, and every RECENTLY_LOST frame,
  the first included, tries to relocalize (accepted at min_inliers_ok).

With a vocabulary (`SlamSystem(cfg, device, vocab=...)`) every KF enters a
BoW database (the loop closer's, or a standalone one without loop
closing). With `cfg.loop` as well, each KF runs place recognition after
its mapping step, and a verified loop is closed at once
(pipeline/loop_closing.py: Atlas merge or pose graph, seam welding), the
current pose carried along and the global BA restarted as per-frame
micro-steps (local_mapping.AsyncGBA). Loop detection acts at the KF rather
than `fused_lag` frames later, in both modes.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Optional

import numpy as np
import torch

from geoflowslam_tpu_torch.config import SystemConfig
from geoflowslam_tpu_torch.io import feed_codec as FC
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.ops import gicp as G
from geoflowslam_tpu_torch.pipeline import local_mapping as LM
from geoflowslam_tpu_torch.pipeline import of_tracking as OF
from geoflowslam_tpu_torch.pipeline import reloc as R
from geoflowslam_tpu_torch.pipeline import tracking as T
from geoflowslam_tpu_torch.pipeline.loop_closing import LoopCloser
from geoflowslam_tpu_torch.retrieval import kf_database as DBD
from geoflowslam_tpu_torch.retrieval import vocab as Vv
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import (FrameData, build_frame,
                                               check_supported)
from geoflowslam_tpu_torch.utils.timers import StageTimers


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


def check_config(cfg: SystemConfig) -> None:
    """Raise on options outside the ported RGB-D, OF/ICP, relocalization
    and loop-closing paths."""
    off = {"imu": cfg.imu is None,
           "use_odom": not cfg.use_odom, "use_lidar": not cfg.use_lidar,
           "stereo_fisheye": cfg.stereo_fisheye is None,
           "local_ba_every_kf=False": cfg.local_ba_every_kf,
           f"sensor={cfg.sensor!r}": cfg.sensor == "rgbd"}
    bad = [name for name, ok in off.items() if not ok]
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))
    check_supported(cfg.frame)


class SlamSystem:
    """RGB-D SLAM on one device. `device` is required to be explicit; a CUDA
    device without CUDA raises instead of running on the CPU. `vocab`
    (retrieval/vocab.py) enables relocalization and, with cfg.loop, loop
    closing."""

    def __init__(self, cfg: SystemConfig, device: torch.device | str,
                 vocab: Optional[Vv.Vocabulary] = None):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlamSystem: CUDA device requested but "
                               "torch.cuda.is_available() is False")
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
        # OF/ICP stages: the previous frame (with its filled OF slots), the
        # RANSAC generator, and device-side counters read only on request
        self.last_frame: Optional[FrameData] = None
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        self._of_last = torch.zeros(2, dtype=torch.long, device=dev)
        self._of_total = torch.zeros(2, dtype=torch.long, device=dev)
        self._icp_accepted = torch.zeros((), dtype=torch.long, device=dev)
        self.n_icp_carried = 0
        self._carried_streak = 0   # consecutive ICP-carried frames
        # recovery and loop closing: the BoW database is the loop closer's,
        # or a standalone one when loop closing is off (the reference's
        # System-owned KeyFrameDatabase)
        self.vocab = vocab.to(dev) if vocab is not None else None
        self.loop_closer = (
            LoopCloser(self.vocab, cfg.k_max, cfg.loop, map_cfg=self.mcfg,
                       device=dev)
            if self.vocab is not None and cfg.loop is not None else None)
        self._reloc_db = (
            DBD.KFDatabase.create(cfg.k_max, self.vocab.n_words, dev)
            if self.vocab is not None and self.loop_closer is None else None)
        self._reloc_gen = torch.Generator(device=dev)
        self._reloc_gen.manual_seed(1234)
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
        self._gba = LM.AsyncGBA(self.mcfg) if cfg.loop is not None else None
        # slot -> (cloud, valid) of the last 40 KFs with use_icp, for the
        # loop closer's use_icp_loop refinement
        self._kf_clouds: dict = {}

    # -- public API ----------------------------------------------------------

    def track_rgbd(self, gray, depth, timestamp: float) -> np.ndarray:
        """Track one frame (gray [H, W] 0..255, depth [H, W] in metres x
        depth_map_factor, numpy or tensors; with feed_codec "m12" also an
        already-packed 1-D uint8 buffer, depth then unused). Returns Twc 4x4
        (float64)."""
        gray, depth = self._encode_feed(gray, depth)
        self._t_rel(timestamp)
        if (self.n_frames > 0 and self.state != TrackingState.NOT_INITIALIZED
                and timestamp < self.last_time):
            warnings.warn("frame timestamp older than the previous frame: "
                          "resetting the active map")
            self.reset_active_map()
        twc = None
        with self.timers.time("Track_total"):
            frame = build_frame(gray, depth, self.cfg.frame, self.cfg.fx,
                                self.cfg.fy, self.cfg.cx, self.cfg.cy)
            if self.state == TrackingState.NOT_INITIALIZED:
                self._initialize(frame, timestamp)
            else:
                frame, twc = self._track_frame(frame, timestamp)
        if self._gba is not None and self._gba.active and self._gba.step():
            self._finish_gba()
        if self.cfg.use_of or self.cfg.use_icp:
            self.last_frame = frame
        self.last_time = timestamp
        self.n_frames += 1
        self.last_levels = frame.feat.level
        return twc if twc is not None else self._record_pose(timestamp)

    def _encode_feed(self, gray, depth):
        """The configured feed on the device: with feed_codec "m12" a
        (gray, depth) pair is packed on the host (io/feed_codec.pack_m12)
        and an already-packed 1-D buffer passes through; depth is then
        None."""
        if self.cfg.frame.feed_codec == "m12" and np.ndim(gray) != 1:
            gray = FC.pack_m12(_host(gray), _host(depth),
                               self.cfg.frame.depth_map_factor)
        gray = torch.as_tensor(gray).to(self.device)
        if gray.dim() == 1:
            return gray, None
        return gray, torch.as_tensor(depth).to(self.device)

    def map_stats(self):
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

    def current_pose_wc(self) -> np.ndarray:
        """Twc 4x4 (camera-to-world), float64."""
        return _twc(self.cur_rot.cpu().numpy(), self.cur_t.cpu().numpy())

    @property
    def trajectory(self):
        """[(t, Twc 4x4)] with lost frames skipped and every entry rebased
        onto its reference KF's current pose (SaveTrajectoryTUM)."""
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
        """System::ResetActiveMap: reinitialize in a fresh Atlas map."""
        self.ms = M.create_new_map(self.ms)
        self._kf_clouds.clear()
        self._restart()

    # -- internals -------------------------------------------------------------

    def _restart(self):
        self.state = TrackingState.NOT_INITIALIZED
        self.has_vel = False
        self.last_obs_mp = None
        self.local_masks = None

    def _t_rel(self, timestamp: float) -> float:
        """Seconds since the session's first frame (f64 on the host; small
        enough for exact float32 storage in the map)."""
        if self.time_base is None:
            self.time_base = float(timestamp)
        return float(timestamp) - self.time_base

    def _free_kf_slot(self) -> int:
        """A slot for the next KF; when every slot holds a live KF of the
        active map, force an aggressive redundancy cull or raise."""
        if int(M.kf_capacity_left(self.ms)) == 0:
            ms, culled = LM.keyframe_culling(
                self.ms, self.ref_kf, protect_recent=0.25, redundancy=0.6)
            culled_i = int(culled)
            if culled_i >= 0:
                self._on_kf_culled(ms, culled_i)
                self.ms = ms
            if int(M.kf_capacity_left(self.ms)) == 0:
                raise RuntimeError(
                    f"KeyFrame capacity exhausted: all {self.ms.k_max} slots "
                    "hold live KFs of the active map and none is redundant "
                    "enough to cull. Raise SystemConfig.k_max.")
        return int(M.free_kf_slot(self.ms))

    def _initialize(self, frame: FrameData, timestamp: float):
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

    def _track_frame(self, frame: FrameData, timestamp: float):
        """Track one frame after initialization; returns the frame with its
        OF slots filled (the next frame's optical-flow source) and the Twc it
        recorded mid-step, or None when the pose is still to record."""
        cfg = self.cfg
        min_ok = cfg.min_inliers_ok
        last_rot, last_t = self.cur_rot, self.cur_t
        if self.has_vel:
            pr, pt = lie.se3_compose(self.vel[0], self.vel[1], last_rot,
                                     last_t)
        else:
            pr, pt = last_rot, last_t
        icp_ok = None
        if cfg.use_icp and self.last_frame is not None:
            pr, pt, icp_ok = self._icp_predict(frame, pr, pt)
        extra_obs = of_innov = None
        if (cfg.use_of and self.last_frame is not None
                and cfg.frame.n_of_slots > 0):
            frame, extra_obs, n3d, n2d, of_innov = OF.of_dual_stream(
                self.ms, self.last_frame, frame, self.last_obs_mp, pr, pt,
                self._gen, self.tcfg, OF.OFConfig(), cfg.frame.n_of_slots)
            self._of_last = torch.stack([n3d, n2d])
            self._of_total = self._of_total + self._of_last
        res = T.track_with_motion_model(self.ms, frame, self.last_obs_mp, pr,
                                        pt, self.tcfg, self.last_levels,
                                        extra_obs=extra_obs)
        n1 = int(res.n_inliers)
        fused = self._fused_mode()
        if n1 < min_ok and not fused:
            # search wider from the unpredicted pose
            wide = dataclasses.replace(self.tcfg, search_radius_mm=40.0)
            res = T.track_with_motion_model(self.ms, frame, self.last_obs_mp,
                                            last_rot, last_t, wide,
                                            self.last_levels)
            n1 = int(res.n_inliers)
        if n1 < min_ok and not fused and self.vocab is not None:
            # BoW-gated matching against the reference KF
            wf = Vv.descend(self.vocab, frame.feat.desc, frame.feat.valid)
            wk = Vv.descend(self.vocab, self.ms.kf_desc[self.ref_kf],
                            self.ms.kf_kp_valid[self.ref_kf])
            res = T.track_reference_keyframe(self.ms, frame, wf, wk,
                                             self.ref_kf, last_rot, last_t,
                                             self.tcfg)
            n1 = int(res.n_inliers)
        ms2, res2 = self.ms, res
        if n1 >= min_ok or fused:
            # the fused step runs the local-map stage on every frame
            if self.local_masks is None:
                self.local_masks = M.local_window(
                    self.ms, self.ref_kf, self.tcfg.local_window,
                    self.tcfg.lm_max_candidates)
            ms2, res2 = T.track_local_map(self.ms, frame, res.obs_mp, res.rot,
                                          res.t, self.tcfg, self.local_masks)
        n2 = res2.n_inliers
        if of_innov is not None:
            # health count: OF-slot inliers whose track never left its
            # predicted start (< 1 px) confirm any prediction on degenerate
            # texture; they feed the pose solve but not the health gate
            n2 = n2 - torch.sum((of_innov < 1.0) & (res2.obs_mp >= 0))
        n2 = int(n2)
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
            self.frames_since_kf += 1
            self._kf_watchdog(timestamp)
            twc = None
            if self._need_new_keyframe(n2):
                if not cfg.record_reproj_err:
                    # the reference's frame step records the tracked pose
                    # against the reference KF before the KF's mapping
                    twc = self._record_pose(timestamp)
                self._insert_keyframe(frame, timestamp, res2, n2)
            return frame, twc
        if fused and (self.state == TrackingState.RECENTLY_LOST
                      or self._carried_streak >= 30):
            rec = R.recover_frame(self.ms, frame, self.last_obs_mp, pr, pt,
                                  self.ref_kf, self.last_levels, self.tcfg,
                                  min_ok, self._reloc_attempt)
            if rec is not None:
                return frame, self._adopt_recovery(rec, timestamp)
        if icp_ok is not None and bool(icp_ok):
            # ICP-carried: the registered pose is the track; the map and
            # the visual bindings stay as they were
            self.state = TrackingState.OK
            self.lost_since = None
            self._carried_streak += 1
            self.n_icp_carried += 1
            self.frames_since_kf += 1
            self._set_pose(pr, pt, last_rot, last_t)
            if timestamp - self._last_kf_time >= 0.5:
                no_obs = torch.full_like(res.obs_mp, M.NO_MP)
                self._insert_keyframe(frame, timestamp,
                                      T.TrackResult(pr, pt, no_obs, 0), 0)
            self._kf_watchdog(timestamp)
            return frame, None
        self.n_lost += 1
        if fused:
            # hold the last pose, motion model and bindings; recovery runs
            # from the next frame on
            self._lost_stamps.add(round(timestamp, 6))
        else:
            self.has_vel = False
        if self.state == TrackingState.OK:
            self.state = TrackingState.RECENTLY_LOST
            self.lost_since = timestamp
        if (self.state == TrackingState.RECENTLY_LOST and not fused
                and self._relocalize(frame)):
            self.state = TrackingState.OK
            self.lost_since = None
            return frame, None
        if self.state == TrackingState.RECENTLY_LOST and (
                timestamp - self.lost_since > self.cfg.time_recently_lost):
            self.state = TrackingState.LOST
            self._reset_or_new_map()
        return frame, None

    def _fused_mode(self) -> bool:
        """The reference's default recovery (see the module docstring)."""
        return self.vocab is not None and not self.cfg.record_reproj_err

    def _adopt_recovery(self, rec: R.Recovery,
                        timestamp: float) -> np.ndarray:
        """A frame recovered by recover_frame: its pose and bindings, the
        motion model reset, the matched KF as reference (when live), the
        local window rebuilt on the next frame; returns the pose, recorded
        without a reference KF."""
        self.cur_rot, self.cur_t = rec.rot, rec.t
        self.last_obs_mp = rec.obs_mp
        self.vel = (torch.eye(3, device=self.device),
                    torch.zeros(3, device=self.device))
        self.has_vel = True
        if rec.kf in self._kf_gen and bool(self.ms.kf_valid[rec.kf]):
            self.ref_kf = rec.kf
        self.local_masks = None
        self._carried_streak = 0
        self.frames_since_kf += 1
        self.state = TrackingState.OK
        self.lost_since = None
        self.n_recovered += 1
        self.n_reloc += rec.relocalized
        return self._record_pose(timestamp, with_ref=False)

    def _reloc_attempt(self, frame: FrameData):
        """One reloc_core call on the active map (one K4 launch on the
        card): (n_inl, rot, t, obs_mp, cand)."""
        return R.reloc_core(
            self.vocab, self.reloc_db, self.ms, frame, self._reloc_gen,
            self.tcfg, self.cfg.frame.orb.width, self.cfg.frame.orb.height)

    def _relocalize(self, frame: FrameData) -> bool:
        """Tracking::Relocalization over the top-3 BoW candidates of the
        active map (the staged mode); adopts the pose when pose-only GN
        keeps min_inliers_ok inliers."""
        if self.vocab is None:
            return False
        n_inl, rot, t, obs2, _ = self._reloc_attempt(frame)
        if int(n_inl) < self.cfg.min_inliers_ok:
            return False
        self.cur_rot, self.cur_t = rot, t
        self.last_obs_mp = obs2
        self.n_reloc += 1
        return True

    def _kf_watchdog(self, timestamp: float):
        """Count and warn, at most every 10 s, when no keyframe has landed
        for more than 10 s while tracking holds."""
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

    def _need_new_keyframe(self, n_inliers: int) -> bool:
        """NeedNewKeyFrame essentials (no IMU cadence)."""
        ref = max(self.ref_kf_inliers, 1)
        if n_inliers < 0.35 * ref and self.frames_since_kf >= 1:
            return True   # tracking cliff: insert regardless of cadence
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= self.cfg.kf_max_interval:
            return True
        return n_inliers < self.cfg.kf_tracked_ratio * ref

    def _insert_keyframe(self, frame: FrameData, timestamp: float,
                         res: T.TrackResult, n_inliers: int):
        slot = self._free_kf_slot()
        with self.timers.time("New_KF"):
            # ends in the read of `culled`: includes the step's device work
            ms, new_obs, masks, kf_rot, kf_t, culled, _ = LM.mapping_step(
                self.ms, frame, res.rot, res.t, self._t_rel(timestamp),
                res.obs_mp, self.ref_kf, slot, self.tcfg, self.mcfg)
            culled_i = int(culled)
        if culled_i >= 0:
            self._on_kf_culled(ms, culled_i)
        self.ms = ms
        self.local_masks = masks
        # the tracked pose is the KF's pose before BA: fold BA's correction
        # of the KF into it (cur o old^-1 o new); the frame-to-frame motion
        # model is invariant to this right-side world correction. The
        # reference's frame step keeps the frame's tracked bindings (the
        # KF's new close points join through the local map); its staged
        # path tracks on from the KF's bindings after mapping
        ri, ti = lie.se3_inverse(res.rot, res.t)
        dr, dt = lie.se3_compose(ri, ti, kf_rot, kf_t)
        self.cur_rot, self.cur_t = lie.se3_compose(self.cur_rot, self.cur_t,
                                                   dr, dt)
        if self.cfg.record_reproj_err:
            self.last_obs_mp = new_obs
        self.ref_kf = slot
        self.ref_kf_inliers = n_inliers
        self.frames_since_kf = 0
        self._last_kf_time = timestamp
        self._gen_counter += 1
        self._kf_gen[slot] = self._gen_counter
        if self.cfg.use_icp:
            # insertion order, a reused slot re-entering as the newest
            self._kf_clouds.pop(slot, None)
            self._kf_clouds[slot] = (frame.cloud, frame.cloud_valid)
            while len(self._kf_clouds) > 40:
                self._kf_clouds.pop(next(iter(self._kf_clouds)))
        if self.loop_closer is None:
            self._db_insert_kf(slot)
            return
        self.ms, found = self.loop_closer.on_keyframe(
            self.ms, slot, kf_clouds=self._kf_clouds or None)
        if not found:
            return
        # the correction moved the map: carry the KF's correction onto the
        # current pose, drop dead bindings, restart the global BA
        self._carry_ref_correction(kf_rot, kf_t)
        obs = self.ms.kf_obs_mp[slot]
        self.last_obs_mp = torch.where(
            (obs >= 0) & self.ms.mp_valid[torch.clamp_min(obs, 0).long()],
            obs, M.NO_MP)
        self.local_masks = None
        if self._gba is not None and self.cfg.loop.async_global_ba:
            self._gba.abort()
            self._gba.start(self.ms)

    def _carry_ref_correction(self, r_ref_old, t_ref_old):
        """The map moved under the tracker: T_cur' = T_cur T_ref_old^-1
        T_ref_new with the reference KF's old and new poses."""
        ri, ti = lie.se3_inverse(r_ref_old, t_ref_old)
        dr, dt = lie.se3_compose(ri, ti, self.ms.kf_rot[self.ref_kf],
                                 self.ms.kf_t[self.ref_kf])
        self.cur_rot, self.cur_t = lie.se3_compose(self.cur_rot, self.cur_t,
                                                   dr, dt)
        self.has_vel = False

    def _finish_gba(self):
        """Write the finished global BA back and carry the reference KF's
        correction onto the current pose when tracking."""
        r_old, t_old = self.ms.kf_rot[self.ref_kf], self.ms.kf_t[self.ref_kf]
        self.ms = self._gba.finish(self.ms)
        if self.state == TrackingState.OK:
            self._carry_ref_correction(r_old, t_old)
        self.local_masks = None

    def _on_kf_culled(self, ms: M.MapState, culled: int):
        """Snapshot T_culled<-parent for trajectory rebasing (mTcp), and
        drop the KF from the BoW database."""
        if self.loop_closer is not None:
            self.loop_closer.db = DBD.erase_keyframe(self.loop_closer.db,
                                                     culled)
        elif self._reloc_db is not None:
            self._reloc_db = DBD.erase_keyframe(self._reloc_db, culled)
        gen = self._kf_gen.get(culled)
        prev = int(ms.kf_prev[culled])
        if gen is not None and 0 <= prev < ms.k_max and bool(
                ms.kf_valid[prev]):
            rc, tc = ms.kf_rot[culled], ms.kf_t[culled]
            rp, tp = ms.kf_rot[prev], ms.kf_t[prev]
            r_cp = rc @ rp.T
            t_cp = tc - r_cp @ tp
            rel = torch.cat([r_cp, t_cp[:, None]], 1).cpu().numpy()
            self._culled_rel[(culled, gen)] = (prev, self._kf_gen.get(prev),
                                               rel.astype(np.float64))

    def _reset_or_new_map(self):
        """Atlas recovery: start a new map when the active one holds enough
        KFs (Tracking::CreateMapInAtlas), then reinitialize."""
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


def _twc(r_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """4x4 camera-to-world from Tcw (float64)."""
    out = np.eye(4)
    out[:3, :3] = np.asarray(r_cw, np.float64).T
    out[:3, 3] = -out[:3, :3] @ np.asarray(t_cw, np.float64)
    return out
