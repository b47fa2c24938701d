"""Inertial state of the tracker (port of
geoflowslam_tpu/pipeline/inertial.py): preintegration buffers, the state
prediction and the IMU initialization.

The host keeps the raw samples since the last keyframe and one
Preintegrated per KF gap (mpImuPreintegratedFromLastKF), all host numpy;
the body state (world-from-body pose, velocity, bias) of the last frame
lives on the device. The initialization follows the closed-form
decomposition of LocalMapping::InitializeIMU: the gyro-bias GN, the linear
gravity / velocity (/ scale) solve or, with imu_method 2, the analytic
accelerometer solve, then the gravity alignment and one apply on the
device (imu/init_np.py runs the solves on host data: one gather of the KF
states, one read).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from geoflowslam_tpu_torch.config import ImuConfig
from geoflowslam_tpu_torch.imu import init_np as NI
from geoflowslam_tpu_torch.imu import preintegration as pre
from geoflowslam_tpu_torch.ops.indexing import scatter_set
from geoflowslam_tpu_torch.solvers import inertial as VI
from geoflowslam_tpu_torch.solvers.inertial_ba import ImuSegments
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.utils.device_const import upload

INIT_W = 10   # KF window of the initialization and the scale refinement
              # (the reference initializes over ~10 recent KFs)
SEG_CAPACITY = 512   # samples of a KF segment; longer gaps are decimated


def apply_imu_init(ms: M.MapState, r_wg, scale: float, slots, vels,
                   bias) -> M.MapState:
    """A successful IMU initialization on the map: gravity alignment and
    rescale (ApplyScaledRotation), then the chain KFs' velocities and the
    bias (UpdateFrameIMU)."""
    dev = ms.kf_vel.device
    ms = M.apply_scaled_rotation(ms, torch.as_tensor(r_wg, device=dev),
                                 float(scale))
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
    vel = torch.as_tensor(np.asarray(vels, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(bias, np.float32), device=dev)
    return ms._replace(
        kf_vel=scatter_set(ms.kf_vel, idx, vel),
        kf_bias=scatter_set(ms.kf_bias, idx, b.expand(idx.shape[0], 6)),
        imu_initialized=torch.ones_like(ms.imu_initialized))


class InertialTracker:
    """Host-side inertial state: preintegration buffers, the body state of
    the last frame (on `device`) and the initialization machine."""

    def __init__(self, cfg: ImuConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.calib = cfg.calib()
        t_bc = np.asarray(cfg.t_bc, np.float32)
        r_bc = t_bc[:3, :3]
        self.r_cb_np = r_bc.T.copy()
        self.t_cb_np = (-r_bc.T @ t_bc[:3, 3]).astype(np.float32)
        self.r_cb = torch.from_numpy(self.r_cb_np).to(self.device)
        self.t_cb = torch.from_numpy(self.t_cb_np).to(self.device)
        self.bias = np.zeros(6, np.float32)
        self.body: Optional[VI.BodyState] = None       # state at last frame
        self.initialized = False
        # (r_wg, s) of the last map rescale, for the trajectory rewrite
        self.last_transform = None
        self.kf_preints: Dict[int, pre.Preintegrated] = {}
        self.kf_order: List[int] = []                  # insertion order
        self.init_time: Optional[float] = None         # mTinit
        self.viba1_done = False
        self.viba2_done = False
        self.seg_capacity = SEG_CAPACITY
        self._chunks: List[tuple] = []                 # samples since last KF
        self.walk_info = np.linalg.inv(
            self.calib.cov_walk + 1e-12 * np.eye(6)).astype(np.float32)
        self.walk_info_dev = torch.from_numpy(self.walk_info).to(self.device)

    # -- the bias, on the host and mirrored on the device --------------------

    @property
    def bias(self) -> np.ndarray:
        return self._bias

    @bias.setter
    def bias(self, value):
        self._bias = np.asarray(value, np.float32).copy()
        self._bias_dev = None

    def set_bias(self, host: np.ndarray, on_device: torch.Tensor):
        """The bias as read back from the device tensor it came from."""
        self.bias = host
        self._bias_dev = on_device

    def bias_on_device(self) -> torch.Tensor:
        if self._bias_dev is None:
            self._bias_dev = upload(self._bias, self.device)
        return self._bias_dev

    # -- preintegration ------------------------------------------------------

    @property
    def pending(self) -> Optional[pre.Preintegrated]:
        """Preintegration of the samples since the last KF, at the fixed
        segment capacity."""
        if not self._chunks:
            return None
        acc, gyro, dts = self._stack_chunks_np()
        return pre.preintegrate(acc, gyro, dts, self.bias, self.calib)

    @pending.setter
    def pending(self, value):
        self._chunks = [] if value is None else [
            (value.meas_acc, value.meas_gyro, value.meas_dt, None)]

    def _stack_chunks_np(self):
        """The chunks' valid samples in order, padded to the segment
        capacity; past it, pairs are merged (dts summed, measurements
        averaged, an odd trailing sample kept) until they fit."""
        acc = np.concatenate([np.asarray(c[0]) for c in self._chunks])
        gyro = np.concatenate([np.asarray(c[1]) for c in self._chunks])
        dts = np.concatenate([np.asarray(c[2]) for c in self._chunks])
        sel = dts > 0
        acc, gyro, dts = acc[sel], gyro[sel], dts[sel]
        cap = self.seg_capacity
        while len(dts) > cap:
            n2 = (len(dts) // 2) * 2
            tail = slice(n2, len(dts))
            acc = np.concatenate(
                [0.5 * (acc[:n2:2] + acc[1:n2:2]), acc[tail]])
            gyro = np.concatenate(
                [0.5 * (gyro[:n2:2] + gyro[1:n2:2]), gyro[tail]])
            dts = np.concatenate([dts[:n2:2] + dts[1:n2:2], dts[tail]])
        pad = cap - len(dts)
        acc = np.pad(acc, ((0, pad), (0, 0))).astype(np.float32)
        gyro = np.pad(gyro, ((0, pad), (0, 0))).astype(np.float32)
        dts = np.pad(dts, (0, pad)).astype(np.float32)
        return acc, gyro, dts

    def preintegrate_frame(self, acc, gyro, dts,
                           timestamp=None) -> pre.Preintegrated:
        """Preintegration of the gap (last frame, this frame] with the
        current bias (host numpy); the samples join the pending KF segment,
        tagged with the frame's time."""
        acc, gyro, dts = (pre.host_f32(x) for x in (acc, gyro, dts))
        self._chunks.append((acc, gyro, dts, timestamp))
        return pre.preintegrate(acc, gyro, dts, self.bias, self.calib)

    def predict(self, p_frame: pre.Preintegrated) -> VI.BodyState:
        """PredictStateIMU from the last frame's body state; `p_frame` is on
        the device."""
        b = self.body
        bias = self.bias_on_device()
        r, t, v = pre.predict_state(b.r_wb, b.p, b.v, p_frame, bias)
        return VI.BodyState(r_wb=r, p=t, v=v, bg=bias[:3], ba=bias[3:])

    def body_from_cam(self, rot_cw, t_cw, v=None) -> VI.BodyState:
        """Tcw -> body state with the current bias (zero velocity unless
        given)."""
        r_wb, p_wb = VI.body_from_cam(rot_cw, t_cw, self.r_cb, self.t_cb)
        bias = self.bias_on_device()
        if v is None:
            v = torch.zeros(3, device=self.device)
        return VI.BodyState(r_wb=r_wb, p=p_wb, v=v, bg=bias[:3],
                            ba=bias[3:])

    def cam_from_body(self, s: VI.BodyState):
        return VI.cam_pose_from_body(s, self.r_cb, self.t_cb)

    def merge_segments(self, a: pre.Preintegrated,
                       b: pre.Preintegrated) -> pre.Preintegrated:
        """MergePrevious at the fixed capacity (decimating compaction)."""
        saved = self._chunks
        self._chunks = [(a.meas_acc, a.meas_gyro, a.meas_dt, None),
                        (b.meas_acc, b.meas_gyro, b.meas_dt, None)]
        acc, gyro, dts = self._stack_chunks_np()
        self._chunks = saved
        return pre.preintegrate(acc, gyro, dts, b.bias, self.calib)

    # -- keyframes -----------------------------------------------------------

    def on_keyframe(self, kf_slot: int, upto_ts: Optional[float] = None):
        """Bind the pending preintegration to the new KF: the chunks up to
        the KF frame's time `upto_ts` form its segment, later ones stay
        pending."""
        if upto_ts is None:
            take, keep = self._chunks, []
        else:
            late = [c[3] is not None and c[3] > upto_ts + 1e-9
                    for c in self._chunks]
            take = [c for c, x in zip(self._chunks, late) if not x]
            keep = [c for c, x in zip(self._chunks, late) if x]
        self._chunks = take
        p = self.pending
        if p is not None:
            self.kf_preints[kf_slot] = p
        self.kf_order.append(kf_slot)
        self._chunks = keep

    def contiguous_window(self, max_kfs: int) -> List[int]:
        """Longest suffix of the KF chain where every segment has a
        preintegration, capped at max_kfs."""
        chain: List[int] = []
        for s in reversed(self.kf_order):
            if chain and chain[-1] not in self.kf_preints:
                break
            chain.append(s)
        return list(reversed(chain))[-max_kfs:]

    def build_segments(self, slots) -> ImuSegments:
        """The window's KF segments stacked on the device (one copy);
        segment i joins slots[i] -> slots[i + 1], invalid where slots[i + 1]
        has no preintegration."""
        ident = pre.Preintegrated.identity(1)
        eye9 = np.eye(9, dtype=np.float32)
        eye6 = np.eye(6, dtype=np.float32)
        names = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
        cols = {k: [] for k in names + ("info9", "walk_info", "dt", "bias0",
                                        "valid")}
        for s in slots[1:]:
            p = self.kf_preints.get(s)
            cols["valid"].append(p is not None and float(p.dt) > 1e-6)
            p = ident if p is None else p
            for k in names:
                cols[k].append(getattr(p, k))
            # the covariance floor keeps the information finite on short,
            # smooth segments; the bias walk is the segment's accumulated one
            cols["info9"].append(np.linalg.inv(p.cov[:9, :9] + 1e-6 * eye9))
            cols["walk_info"].append(np.linalg.inv(p.cov[9:15, 9:15]
                                                   + 1e-10 * eye6))
            cols["dt"].append(p.dt)
            cols["bias0"].append(p.bias)
        arrays = {k: np.stack([np.asarray(x, np.float32) for x in v])
                  for k, v in cols.items()}
        flat = np.concatenate([a.reshape(-1) for a in arrays.values()])
        buf = torch.from_numpy(flat).to(self.device)
        out, i = {}, 0
        for k, a in arrays.items():
            out[k] = buf[i:i + a.size].reshape(a.shape)
            i += a.size
        out["valid"] = out["valid"] > 0.5
        return ImuSegments(**out)

    # -- initialization ------------------------------------------------------

    def _gather_states_np(self, ms: M.MapState, chain):
        """(r_wb [n, 3, 3], p_wb [n, 3], v [n, 3], times [n]) of the chain
        KFs, float64, in one device read."""
        idx = torch.as_tensor(chain, device=ms.kf_rot.device)
        pkt = torch.cat([ms.kf_rot[idx].reshape(-1, 9), ms.kf_t[idx],
                         ms.kf_vel[idx], ms.kf_time[idx].float()[:, None]],
                        1).cpu().numpy().astype(np.float64)
        rots_cw = pkt[:, :9].reshape(-1, 3, 3)
        r_wc = np.swapaxes(rots_cw, 1, 2)
        t_wc = -np.einsum("nij,nj->ni", r_wc, pkt[:, 9:12])
        r_cb = self.r_cb_np.astype(np.float64)
        t_cb = self.t_cb_np.astype(np.float64)
        r_wb = r_wc @ r_cb
        p_wb = np.einsum("nij,j->ni", r_wc, t_cb) + t_wc
        return r_wb, p_wb, pkt[:, 12:15], pkt[:, 15]

    def scale_refinement(self, ms: M.MapState) -> M.MapState:
        """ScaleRefinement: re-estimate the map scale and a small gravity
        correction against the KF segments with the map's velocities, and
        rescale the map when it drifted by more than 0.2%."""
        chain = self.contiguous_window(INIT_W)
        if len(chain) < 4:
            return ms
        r_wb, p_wb, v_wb, _ = self._gather_states_np(ms, chain)
        pr = [pre.reintegrate(self.kf_preints[s], self.bias, self.calib)
              for s in chain[1:]]
        s_f, grav = NI.solve_scale_refinement_np(
            r_wb, p_wb, np.asarray([float(p.dt) for p in pr]),
            np.stack([p.dV for p in pr]), np.stack([p.dP for p in pr]),
            v_wb[:-1])
        if not (0.3 < s_f < 3.0) or abs(s_f - 1.0) <= 0.002:
            return ms
        r_wg = NI.gravity_alignment_rotation_np(grav)
        self.last_transform = (r_wg, float(s_f))
        return M.apply_scaled_rotation(
            ms, torch.as_tensor(r_wg, device=ms.kf_rot.device), float(s_f))

    def try_initialize(self, ms: M.MapState, scale_free: bool = False):
        """InitializeIMU over the longest contiguous suffix of the KF chain
        (at most INIT_W KFs, init_min_kfs and init_min_time s at least).
        Returns (ms, did_init)."""
        if self.initialized or len(self.kf_order) < self.cfg.init_min_kfs:
            return ms, False
        chain = self.contiguous_window(INIT_W)
        if len(chain) - 1 < self.cfg.init_min_kfs - 1:
            return ms, False
        r_wb, p_wb, _, times = self._gather_states_np(ms, chain)
        if float(times[-1] - times[1]) < self.cfg.init_min_time:
            return ms, False
        return self._solve_and_apply(ms, chain, r_wb, p_wb, scale_free)

    def reinitialize(self, ms: M.MapState, scale_free: bool = False):
        """The VIBA1/VIBA2 re-runs of InitializeIMU over the grown chain
        (poses fixed). Returns (ms, did)."""
        if not self.initialized:
            return ms, False
        chain = self.contiguous_window(INIT_W)
        if len(chain) < 4:
            return ms, False
        r_wb, p_wb, _, _ = self._gather_states_np(ms, chain)
        return self._solve_and_apply(ms, chain, r_wb, p_wb, scale_free)

    def _solve_and_apply(self, ms, chain, r_wb, p_wb, scale_free):
        pr = [self.kf_preints[s] for s in chain[1:]]
        # 1) gyro bias; the accelerometer bias stays (zero at the first
        # init) unless method 2 solves it below
        bg = NI.solve_gyro_bias_np(r_wb, np.stack([p.dR for p in pr]),
                                   np.stack([p.JRg for p in pr]))
        new_bias = np.concatenate([bg.astype(np.float32), self.bias[3:]])
        pr = [pre.reintegrate(p, new_bias, self.calib) for p in pr]
        dts = np.asarray([float(p.dt) for p in pr])
        d_vs = np.stack([p.dV for p in pr])
        d_ps = np.stack([p.dP for p in pr])
        # 2) gravity and velocities (and the scale for mono)
        ba = np.zeros(3, np.float32)
        if self.cfg.imu_method == 2:
            vels, grav, ba, scale = NI.solve_accelerometer_analytic_np(
                r_wb, p_wb, dts, d_vs, d_ps, np.stack([p.JPa for p in pr]),
                np.stack([p.JVa for p in pr]), solve_scale=scale_free)
            if np.linalg.norm(ba) > 1.0:
                ba = np.zeros(3, np.float32)   # implausible: keep g, s only
        else:
            vels, grav, scale = NI.solve_gravity_scale_velocities_np(
                r_wb, p_wb, dts, d_vs, d_ps, solve_scale=scale_free)
        if not 7.0 < float(np.linalg.norm(grav)) < 12.0:
            return ms, False
        if scale_free and not 0.05 < float(scale) < 20.0:
            return ms, False
        # the solved (v, g, s) must explain the position constraints
        resid, mags = [], []
        for i in range(len(pr)):
            dt = dts[i]
            lhs = float(scale) * (p_wb[i + 1] - p_wb[i])
            rhs = vels[i] * dt + 0.5 * grav * dt * dt + r_wb[i] @ d_ps[i]
            resid.append(float(np.linalg.norm(lhs - rhs)))
            mags.append(float(np.linalg.norm(lhs)) + 1e-3)
        if np.median(resid) > 0.15 * np.median(mags) + 0.02:
            return ms, False
        # 3) gravity to -z, the map rescaled; the solved velocities are
        # metric already and only rotate
        r_wg = NI.gravity_alignment_rotation_np(grav)
        vels_aligned = (vels @ r_wg.T.astype(np.float64)).astype(np.float32)
        if self.cfg.imu_method == 2:
            new_bias = np.concatenate([new_bias[:3], ba])
        ms = apply_imu_init(ms, r_wg, np.float32(scale), chain, vels_aligned,
                            new_bias)
        self.last_transform = (r_wg, float(scale))
        self.bias = new_bias
        self.initialized = True
        return ms, True


def body_state_at(rot_cw, t_cw, v, r_cb, t_cb, bias) -> VI.BodyState:
    """The body state at camera pose Tcw with velocity v and the bias [6]
    (bg, ba)."""
    r_wb, p_wb = VI.body_from_cam(rot_cw, t_cw, r_cb, t_cb)
    return VI.BodyState(r_wb=r_wb, p=p_wb, v=v, bg=bias[:3], ba=bias[3:])


def refine_frame(mode: str, ms: M.MapState, frame, res, s1: VI.BodyState,
                 pred_body: VI.BodyState, p_frame: pre.Preintegrated,
                 prior, r_cb, t_cb, bias, tcfg, min_inliers: int):
    """The fused frame step's VI refinement (geoflowslam_tpu/pipeline/
    fused.py:248-299) of a visually tracked frame, on the device: the body
    state at the visual pose with the IMU-predicted velocity, optimized
    against the last state s1 (`mode` "kf") or jointly with it under its
    marginalized prior ("prior"), 2 rounds x 6 iterations. The VI state is
    accepted when it keeps max(min_inliers, n_visual / 2) inliers; otherwise
    the visual pose stands with a finite-difference velocity. `bias` [6]
    (bg, ba) is the current bias on the device. Returns (rot, t, obs_mp,
    n_vi [], accepted [], body state, marginal information)."""
    feat = frame.feat
    mp_idx = torch.clamp_min(res.obs_mp, 0).long()
    valid = (res.obs_mp >= 0) & ms.mp_valid[mp_idx] & feat.valid
    obs = VI.PoseObs(
        pts_w=ms.mp_pos[mp_idx], uv=feat.uv, u_right=frame.u_right,
        is_stereo=valid & (frame.u_right > 0),
        inv_sigma2=1.0 / (tcfg.scale_factor ** feat.level.float()) ** 2,
        valid=valid)
    s2_vis = body_state_at(res.rot, res.t, pred_body.v, r_cb, t_cb, bias)
    args = (obs, r_cb, t_cb, tcfg.fx, tcfg.fy, tcfg.cx, tcfg.cy, tcfg.bf)
    if mode == "kf":
        s2, inl, n_vi, marg = VI.inertial_pose_optimization(
            s2_vis, s1, p_frame, *args, rounds=2, iters=6, return_info=True)
    else:
        s2, inl, n_vi, marg = VI.inertial_pose_optimization_joint(
            s2_vis, s1, prior, p_frame, *args, rounds=2, iters=6)
    rot_vi, t_vi = VI.cam_pose_from_body(s2, r_cb, t_cb)
    need = torch.clamp_min((res.n_inliers.float() * 0.5).int(), min_inliers)
    accept = n_vi >= need
    rot = torch.where(accept, rot_vi, res.rot)
    t = torch.where(accept, t_vi, res.t)
    obs_mp = torch.where(accept, torch.where(inl, res.obs_mp, M.NO_MP),
                         res.obs_mp)
    p_vis = rot.T @ (t_cb - t)
    v_fd = (p_vis - s1.p) / torch.clamp_min(p_frame.dt, 1e-4)
    body_vis = body_state_at(rot, t, v_fd, r_cb, t_cb, bias)
    body = VI.BodyState(*(torch.where(accept, a, b)
                          for a, b in zip(s2, body_vis)))
    return rot, t, obs_mp, n_vi, accept, body, marg
