"""The fused frame step (port of geoflowslam_tpu/pipeline/fused.py): one
RGB-D or RGB-D-inertial frame as one function on device tensors that hands
the host one packed float32 packet.

    [IMU prediction] -> build_frame -> [GICP/NDT predictor] -> [dual-stream
    OF append] -> track_with_motion_model -> track_local_map -> [OF health
    discount] -> [lidar point-to-plane refine] -> [VI refine and acceptance]
    -> on-device health gate -> [recovery] -> motion model -> trel -> packet

Every decision is a device-side select (`tree_where`, `torch.where`); the
stages are the port's functions. The only host read allowed is the
recovery variant's: where the reference runs its re-search and
relocalization under `lax.cond`, this step reads whether the frame's track
failed and runs them only then. The caller reads `host_pkt` once:

    [n_mm, n_lm, n_vi, vi_accepted, twc (12), trel (12), bias (6), aux,
     relocalized]

the reference's 35 values (aux: 0 tracked, 1 ICP-carried, 2 + slot
recovered onto that KF) and one more, 1.0 when the recovery's pose came
from the relocalization rather than the 40 px re-search.

What differs from the reference's arguments: `p_frame` (the frame gap's
Preintegrated, on the device) replaces the raw samples and their
calibration, as the port preintegrates on the host; the optical flow draws
from a torch Generator (`gen`) in place of keys derived from the packet
sequence; there is no packet ring (`pkt_window`, `seq`); the caller's
`relocalize(frame)` replaces `reloc_vocab`/`reloc_db` and the
relocalization's key; `device` is explicit. FusedOut adds the
registration's verdict and the plane-factor count, which the façade's
counters read on request.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.config import FrameConfig, LidarConfig, TrackConfig
from geoflowslam_tpu_torch.imu import preintegration as pre
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.ops import gicp as G
from geoflowslam_tpu_torch.pipeline import inertial as IN
from geoflowslam_tpu_torch.pipeline import lidar_mapping as LD
from geoflowslam_tpu_torch.pipeline import of_tracking as OF
from geoflowslam_tpu_torch.pipeline import reloc as R
from geoflowslam_tpu_torch.pipeline import tracking as T
from geoflowslam_tpu_torch.solvers import inertial as VI
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import FrameData, build_frame

PKT_LEN = 36       # the reference's 35 values + the relocalized flag
PKT_AUX = 34
PKT_RELOC = 35


class FusedOut(NamedTuple):
    frame: FrameData          # the built frame, OF slots filled
    rot: torch.Tensor         # final Tcw
    t: torch.Tensor
    obs_mp: torch.Tensor      # [N] final per-keypoint map-point binding
    ms: M.MapState            # with the found/visible counters (gated)
    vel_rot: torch.Tensor     # updated motion model Tcl
    vel_t: torch.Tensor
    p_frame: Optional[pre.Preintegrated]   # the frame gap (IMU modes)
    body: Optional[VI.BodyState]           # updated body state (kf, prior)
    marg: Optional[torch.Tensor]           # marginal for the next prior
    scalars: torch.Tensor     # [4] int: n_mm, n_lm, n_vi, vi_accepted
    twc: torch.Tensor         # [3, 4] camera-to-world
    trel: torch.Tensor        # [3, 4] T_cr against the reference KF
    bias_out: Optional[torch.Tensor]       # [6] (bg, ba) in kf, prior
    host_pkt: torch.Tensor    # [PKT_LEN] float32, the one host read
    of_counts: Optional[torch.Tensor]      # [2] (n_3d, n_2d) with OF
    icp_ok: Optional[torch.Tensor] = None  # [] bool: registration accepted
    n_planes: Optional[torch.Tensor] = None  # [] valid plane factors


def tree_where(c: torch.Tensor, a, b):
    """Field-wise torch.where(c, a, b) over two NamedTuples of tensors; a
    field that is the same tensor on both sides is left alone (XLA folds
    select(c, x, x) for the reference; here it saves copying the untouched
    fields of a MapState every frame)."""
    return type(a)(*(x if x is y else torch.where(
        c.reshape((1,) * x.dim()) if x.dim() else c, x, y)
        for x, y in zip(a, b)))


def frame_step(gray, depth, ms: M.MapState, last_obs_mp, last_levels,
               vel_rot, vel_t, use_vel: bool, cur_rot, cur_t, ref_kf: int,
               local_masks, p_frame: Optional[pre.Preintegrated],
               body: Optional[VI.BodyState], bias, prior_info, r_cb, t_cb,
               cfg: TrackConfig, fcfg: FrameConfig, imu_mode: str,
               min_inliers: int, *, device,
               last_frame: Optional[FrameData] = None, use_of: bool = False,
               use_icp: bool = False, icp_method: str = "gicp",
               icp_min_inliers: int = 200, n_of_slots: int = 0,
               ofcfg: Optional[OF.OFConfig] = None,
               gen: Optional[torch.Generator] = None,
               of_gumbel=None, use_lidar: bool = False, lidar_map=None,
               lidar_cfg: Optional[LidarConfig] = None,
               with_recovery: bool = False,
               relocalize: Optional[Callable] = None) -> FusedOut:
    """One fused frame. imu_mode:
      "off"   - visual only (p_frame, body, bias, ... may be None)
      "raw"   - IMU samples but no initialized IMU: the gap is carried only
      "kf"    - VI refinement against the last KF-anchored body state
                (returns the marginal)
      "prior" - joint VI refinement with the last frame's state under its
                marginalized prior `prior_info`
    gray/depth: the frame's images on `device` (an m12 buffer with depth
    None under feed_codec "m12"); every state tensor is on `device`.
    use_icp / use_of need `last_frame`; use_lidar needs `lidar_map`;
    with_recovery needs `relocalize(frame)`, which returns reloc_core's
    tuple. `of_gumbel` (noise of the 3D and the 2D stream) replaces the
    optical flow's draws."""
    dev = torch.device(device)
    kf_modes = imu_mode in ("kf", "prior")

    # ---- 1. prediction: IMU state or motion model -------------------------
    pred_body = None
    if kf_modes:
        r_wb2, p2, v2 = pre.predict_state(body.r_wb, body.p, body.v,
                                          p_frame, bias)
        pred_body = VI.BodyState(r_wb=r_wb2, p=p2, v=v2, bg=bias[:3],
                                 ba=bias[3:])
        pr, pt = VI.cam_pose_from_body(pred_body, r_cb, t_cb)
    elif use_vel:
        pr, pt = lie.se3_compose(vel_rot, vel_t, cur_rot, cur_t)
    else:
        pr, pt = cur_rot, cur_t

    # ---- 2. frame build ----------------------------------------------------
    frame = build_frame(gray, depth, fcfg, cfg.fx, cfg.fy, cfg.cx, cfg.cy)

    # ---- 3. GICP/NDT predictor (PredictStateICP) ---------------------------
    icp_held = torch.zeros((), dtype=torch.bool, device=dev)
    icp_ok = None
    if use_icp and last_frame is not None:
        # init: T_lc = T_lw T_cw_pred^-1 (cur_* is the last frame's pose)
        pri, pti = lie.se3_inverse(pr, pt)
        r0, t0 = lie.se3_compose(cur_rot, cur_t, pri, pti)
        register = G.ndt_register if icp_method == "ndt" else G.gicp_register
        reg = register(frame.cloud, frame.cloud_valid, last_frame.cloud,
                       last_frame.cloud_valid, init_rot=r0, init_t=t0)
        # a degenerate (planar) cloud "converges" onto any in-plane init; no
        # camera here moves 0.5 m or ~20 deg between frames
        dr_cos = 0.5 * (torch.trace(reg.rot) - 1.0)
        plaus = (torch.linalg.norm(reg.t) < 0.5) & (dr_cos > 0.94)
        icp_ok = (reg.converged & (reg.n_inliers >= icp_min_inliers)
                  & plaus)
        rri, rti = lie.se3_inverse(reg.rot, reg.t)
        r_icp, t_icp = lie.se3_compose(rri, rti, cur_rot, cur_t)
        pr = torch.where(icp_ok, r_icp, pr)
        pt = torch.where(icp_ok, t_icp, pt)
        icp_held = icp_ok

    # ---- 4. dual-stream OF append (SearchByProjectionWithOF) ---------------
    extra_obs = of_counts = of_innov = None
    if use_of and last_frame is not None and n_of_slots > 0:
        frame, extra_obs, n3d, n2d, of_innov = OF.of_dual_stream(
            ms, last_frame, frame, last_obs_mp, pr, pt, gen, cfg,
            OF.OFConfig() if ofcfg is None else ofcfg, n_of_slots,
            gumbel=of_gumbel)
        of_counts = torch.stack([n3d, n2d])

    res = T.track_with_motion_model(ms, frame, last_obs_mp, pr, pt, cfg,
                                    last_levels, extra_obs=extra_obs)
    ms2, res2 = T.track_local_map(ms, frame, res.obs_mp, res.rot, res.t,
                                  cfg, local_masks)

    # ---- 5. OF health discount: OF inliers that never left their predicted
    # start confirm any prediction; they feed the solve, not the health ----
    if of_innov is not None:
        confirm = (of_innov < 1.0) & (res2.obs_mp >= 0)
        res2 = res2._replace(n_inliers=res2.n_inliers - torch.sum(confirm))

    # ---- 6. lidar point-to-plane refine (PoseLidarVisualOptimization) -----
    n_planes = None
    if use_lidar and lidar_map is not None:
        pl = LD.make_plane_obs(lidar_map, frame.cloud, frame.cloud_valid,
                               res2.rot, res2.t, lidar_cfg)
        n_planes = pl.valid.sum()
        res2 = T.TrackResult(*T.pose_opt_from_obs(
            ms2, frame, res2.obs_mp, res2.rot, res2.t, cfg, plane_obs=pl,
            rounds=2, iters_per_round=5))

    # ---- 7. VI refinement and acceptance -----------------------------------
    rot_f, t_f, obs_f = res2.rot, res2.t, res2.obs_mp
    n_vi = torch.full((), -1, dtype=torch.long, device=dev)
    accept = torch.zeros((), dtype=torch.bool, device=dev)
    body_out = marg = None
    if kf_modes:
        rot_f, t_f, obs_f, n_vi, accept, body_out, marg = IN.refine_frame(
            imu_mode, ms2, frame, res2, body, pred_body, p_frame, prior_info,
            r_cb, t_cb, bias, cfg, min_inliers)

    # ---- 8. on-device health gate: a failed frame must not poison the
    # chained state; an ICP-carried frame rides the registered pose, an
    # IMU frame dead-reckons, a visual-only failure holds the last pose ----
    n_eff = torch.where(accept, n_vi, res2.n_inliers) if kf_modes \
        else res2.n_inliers
    ok_frame = n_eff >= min_inliers
    carried = icp_held & ~ok_frame
    dead_reckon = carried | kf_modes
    pf_r = torch.where(dead_reckon, pr, cur_rot)
    pf_t = torch.where(dead_reckon, pt, cur_t)
    rot_f = torch.where(ok_frame, rot_f, pf_r)
    t_f = torch.where(ok_frame, t_f, pf_t)
    obs_f = torch.where(ok_frame, obs_f, last_obs_mp)
    ms2 = tree_where(ok_frame, ms2, ms)
    if body_out is not None:
        body_out = tree_where(ok_frame, body_out, pred_body)

    # ---- 9. recovery variant: the re-search and the relocalization, run
    # only on a failed frame (the one host read of the step) ---------------
    relocd = None
    if with_recovery and relocalize is not None:
        relocd = torch.zeros((), dtype=torch.bool, device=dev)
        by_reloc = relocd
        reloc_cand = torch.zeros((), dtype=torch.long, device=dev)
        if not bool(ok_frame):
            rec = R.recover_frame(ms, frame, last_obs_mp, pr, pt, ref_kf,
                                  last_levels, cfg, min_inliers, relocalize)
            relocd = rec.adopted
            by_reloc = relocd & rec.relocalized
            rot_f = torch.where(relocd, rec.rot, rot_f)
            t_f = torch.where(relocd, rec.t, t_f)
            obs_f = torch.where(relocd, rec.obs_mp, obs_f)
            reloc_cand = rec.kf
            if body_out is not None:
                # the body at the recovered pose keeps the dead-reckoned
                # velocity
                body_reloc = IN.body_state_at(rot_f, t_f, body_out.v, r_cb,
                                              t_cb, bias)
                body_out = tree_where(relocd, body_reloc, body_out)

    # ---- 10. motion model Tcl = Tcw Tlw^-1, kept on a failure (unless ICP
    # measured the delta), its translation clamped to 0.5 m ---------------
    lri, lti = lie.se3_inverse(cur_rot, cur_t)
    nvr, nvt = lie.se3_compose(rot_f, t_f, lri, lti)
    learn = ok_frame | carried
    nvr = torch.where(learn, nvr, vel_rot)
    nvt = torch.where(learn, nvt, vel_t)
    nvt = nvt * torch.clamp(
        0.5 / torch.clamp_min(torch.linalg.norm(nvt), 1e-9), max=1.0)
    if relocd is not None:
        # after a recovery the frame-to-frame motion is unknown
        nvr = torch.where(relocd, torch.eye(3, device=dev), nvr)
        nvt = torch.where(relocd, 0.0, nvt)

    # ---- 11. twc and T_cr against the reference KF -------------------------
    rwc = rot_f.T
    twc = torch.cat([rwc, (-(rwc @ t_f))[:, None]], dim=1)
    r_rw, t_rw = ms.kf_rot[ref_kf], ms.kf_t[ref_kf]
    r_cr = rot_f @ r_rw.T
    t_cr = t_f - r_cr @ t_rw
    trel = torch.cat([r_cr, t_cr[:, None]], dim=1)

    # ---- 12. the host packet ------------------------------------------------
    bias_out = (torch.cat([body_out.bg, body_out.ba])
                if body_out is not None else None)
    scalars = torch.stack([res.n_inliers.long(), res2.n_inliers.long(),
                           n_vi.long(), accept.long()])
    # aux: 0 tracked, 1 ICP-carried, 2 + slot recovered (exact in float32
    # for k_max <= 2^23)
    aux = carried.float()
    reloc_flag = torch.zeros((), device=dev)
    if relocd is not None:
        aux = torch.where(relocd, 2.0 + reloc_cand.float(), aux)
        reloc_flag = by_reloc.float()
    host_pkt = torch.cat([
        scalars.float(), twc.reshape(-1), trel.reshape(-1),
        bias_out if bias_out is not None else torch.zeros(6, device=dev),
        aux.reshape(1), reloc_flag.reshape(1)])
    return FusedOut(frame=frame, rot=rot_f, t=t_f, obs_mp=obs_f, ms=ms2,
                    vel_rot=nvr, vel_t=nvt, p_frame=p_frame, body=body_out,
                    marg=marg, scalars=scalars, twc=twc, trel=trel,
                    bias_out=bias_out, host_pkt=host_pkt,
                    of_counts=of_counts, icp_ok=icp_ok, n_planes=n_planes)
