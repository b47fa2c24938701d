"""The port's VI solvers against the JAX package, and their closed-form
Jacobians against forward-mode AD of the same residuals:

* inertial_pose_optimization (the `kf` mode: 2 rounds x 6 iterations,
  return_info) and inertial_pose_optimization_joint (the `prior` mode, with
  the first solve's information as the prior) on one seeded problem: 300
  map points seen from the synthetic trajectory at t = 2 s (0.5 px noise,
  10% outliers, half of them with a right-image coordinate), the IMU
  samples of the frame gap before it, a camera-IMU extrinsic off the
  identity, a start 0.6 deg, 2 cm and 5 cm/s off. Both packages get the
  same inputs (the JAX preintegration): the pose within 1e-4 m and 1e-4
  rad, velocity and bias within 1e-4, the same inlier count (at most 2
  inlier flags differ), the information within 1e-3 of its largest entry;
* EdgeInertial's Jacobians in both states' tangents, EdgePriorPoseImu's,
  the reprojection Jacobian in the body tangent and VI-BA's camera-from-body
  tangent map, in float64 against torch.func.jacfwd of the residuals
  through apply_tangent (VI-BA's own update for the latter): within 1e-6;
* local_mapping.vi_ba_step on a temporal window that the JAX
  InertialTracker built (contiguous_window, build_segments) over a map the
  port tracked with its IMU (320x240, 30 frames at 10 fps): the window's
  KF poses within 1e-4 m and 1e-4 rad of JAX's vi_ba_step, velocities and
  biases within 1e-4, the optimized points within 1e-3 m, the same
  observations pruned.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.imu import preintegration as JP
from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.pipeline import inertial as JIN
from geoflowslam_tpu.pipeline import local_mapping as JLM
from geoflowslam_tpu.solvers import inertial as JVI
from geoflowslam_tpu.solvers.inertial_ba import ImuSegments as JSegs
from geoflowslam_tpu.solvers.pose_opt import PoseObs as JObs
from geoflowslam_tpu.state import map_state as JM

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.imu import preintegration as TP
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.retrieval import vocab as TV
from geoflowslam_tpu_torch.solvers import inertial as VI
from geoflowslam_tpu_torch.solvers import inertial_ba as VIBA
from geoflowslam_tpu_torch.solvers.pose_opt import PoseObs
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

FX, CX, CY, BF = 200.0, 160.0, 120.0, 20.0


def _t_bc():
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.asarray(JL.so3_exp(jnp.array([0.02, -0.03, 0.01])))
    t[:3, 3] = [0.05, -0.02, 0.03]
    return t


def _rot_err(a, b):
    """The angle between two rotations, 2 asin(|A - B|_F / sqrt(8)) (well
    conditioned at small angles, unlike the trace's arccos)."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(2.0 * np.arcsin(min(d / np.sqrt(8.0), 1.0)))


@pytest.fixture(scope="module")
def problem():
    rs = np.random.RandomState(5)
    t1, t2 = 2.0 - 1.0 / 30.0, 2.0
    seq = JS.SyntheticSequence(JS.SyntheticWorld(JS.Camera()), fps=30.0)
    acc, gyro, dts = seq.imu_between(t1, t2, 32)
    imu = JIN.ImuConfig(t_bc=_t_bc())
    calib = imu.calib()
    bias = np.array([0.002, -0.001, 0.003, 0.02, -0.01, 0.015], np.float32)
    preint = JP.preintegrate(acc, gyro, dts, jnp.asarray(bias), calib)
    r_bc, t_bc = _t_bc()[:3, :3], _t_bc()[:3, 3]
    r_cb, t_cb = r_bc.T, -r_bc.T @ t_bc

    def state(t, dphi=None, dp=None, dv=None):
        rot_wc, p, v, *_ = [np.asarray(x, np.float64)
                            for x in JS.smooth_trajectory(jnp.float32(t))]
        r_wb = rot_wc @ r_cb.astype(np.float64)
        p_wb = rot_wc @ t_cb.astype(np.float64) + p
        if dphi is not None:
            r_wb = r_wb @ np.asarray(JL.so3_exp(jnp.asarray(dphi)))
            p_wb, v = p_wb + dp, v + dv
        return [np.asarray(x, np.float32)
                for x in (r_wb, p_wb, v, bias[:3], bias[3:])]

    s1 = state(t1)
    s2_true = state(t2)
    s2_start = state(t2, [0.006, -0.008, 0.004], [0.02, -0.01, 0.015],
                     [0.05, -0.03, 0.02])
    # points in front of the camera at t2, observed with noise
    r_bw = s2_true[0].T
    r_cw = r_cb @ r_bw
    t_cw = r_cb @ (-r_bw @ s2_true[1]) + t_cb
    n = 300
    pc = np.stack([rs.uniform(-1.5, 1.5, n), rs.uniform(-1.0, 1.0, n),
                   rs.uniform(1.0, 4.0, n)], 1)
    pts_w = ((pc - t_cw) @ r_cw).astype(np.float32)
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                   FX * pc[:, 1] / pc[:, 2] + CY], 1)
    uv = uv + rs.randn(n, 2) * 0.5
    out = rs.rand(n) < 0.1
    uv[out] += rs.uniform(-30, 30, (out.sum(), 2))
    stereo = rs.rand(n) < 0.5
    ur = np.where(stereo, uv[:, 0] - BF / pc[:, 2] + rs.randn(n) * 0.5, -1.0)
    levels = rs.randint(0, 4, n)
    obs = dict(pts_w=pts_w, uv=uv.astype(np.float32),
               u_right=ur.astype(np.float32), is_stereo=stereo,
               inv_sigma2=(1.0 / 1.2 ** (2 * levels)).astype(np.float32),
               valid=rs.rand(n) < 0.95)
    return dict(preint=preint, s1=s1, s2=s2_start, obs=obs, r_cb=r_cb,
                t_cb=t_cb)


def _jax_args(pb):
    st = lambda s: JVI.BodyState(*(jnp.asarray(x) for x in s))  # noqa
    return (st(pb["s2"]), st(pb["s1"]), pb["preint"],
            JObs(**{k: jnp.asarray(v) for k, v in pb["obs"].items()}),
            jnp.asarray(pb["r_cb"]), jnp.asarray(pb["t_cb"]))


def _port_args(pb):
    st = lambda s: VI.BodyState(*(torch.tensor(x) for x in s))  # noqa
    p = TP.Preintegrated(*(np.asarray(x) for x in pb["preint"]))
    return (st(pb["s2"]), st(pb["s1"]), TP.to_device(p, "cpu"),
            PoseObs(**{k: torch.tensor(v) for k, v in pb["obs"].items()}),
            torch.tensor(pb["r_cb"]), torch.tensor(pb["t_cb"]))


def _check_state(sj, st):
    np.testing.assert_allclose(st.p.numpy(), np.asarray(sj.p), atol=1e-4,
                               rtol=0)
    assert _rot_err(st.r_wb.numpy(), np.asarray(sj.r_wb)) < 1e-4
    for f in ("v", "bg", "ba"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)), atol=1e-4,
                                   rtol=0, err_msg=f)


def _check_info(it, ij):
    ij = np.asarray(ij)
    np.testing.assert_allclose(it.numpy(), ij, rtol=0,
                               atol=1e-3 * np.abs(ij).max())


def test_pose_optimization_kf_and_joint(problem):
    s2j, s1j, pj, obsj, rcbj, tcbj = _jax_args(problem)
    s2t, s1t, pt, obst, rcbt, tcbt = _port_args(problem)
    cam = (FX, FX, CX, CY, BF)
    sj, inl_j, n_j, info_j = JVI.inertial_pose_optimization(
        s2j, s1j, pj, obsj, rcbj, tcbj, *cam, rounds=2, iters=6,
        return_info=True)
    st, inl_t, n_t, info_t = VI.inertial_pose_optimization(
        s2t, s1t, pt, obst, rcbt, tcbt, *cam, rounds=2, iters=6,
        return_info=True)
    _check_state(sj, st)
    assert int(n_t) == int(n_j) and int(n_t) > 200
    assert int((inl_t.numpy() != np.asarray(inl_j)).sum()) <= 2
    _check_info(info_t, info_j)

    # the prior mode: the solved state as the previous frame, its
    # information as the prior, the same start for the current one
    sj2, inl_j2, n_j2, marg_j = JVI.inertial_pose_optimization_joint(
        s2j, sj, info_j, pj, obsj, rcbj, tcbj, *cam, rounds=2, iters=6)
    st2, inl_t2, n_t2, marg_t = VI.inertial_pose_optimization_joint(
        s2t, st, info_t, pt, obst, rcbt, tcbt, *cam, rounds=2, iters=6)
    _check_state(sj2, st2)
    assert int(n_t2) == int(n_j2)
    assert int((inl_t2.numpy() != np.asarray(inl_j2)).sum()) <= 2
    _check_info(marg_t, marg_j)


def _double(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def _f64(pb):
    s2, s1, p, obs, r_cb, t_cb = _port_args(pb)
    d = _double
    return (VI.BodyState(*map(d, s2)), VI.BodyState(*map(d, s1)),
            TP.Preintegrated(*map(d, p)), PoseObs(*map(d, obs)), d(r_cb),
            d(t_cb))


def test_closed_form_jacobians(problem):
    from torch.func import jacfwd
    s2, s1, p, obs, r_cb, t_cb = _f64(problem)
    z15 = torch.zeros(15, dtype=torch.float64)
    _, j1, j2 = VI.inertial_residual_and_jacobians(s1, s2, p)
    a1 = jacfwd(lambda d: VI.inertial_residual(VI.apply_tangent(s1, d), s2,
                                               p))(z15)
    a2 = jacfwd(lambda d: VI.inertial_residual(s1, VI.apply_tangent(s2, d),
                                               p))(z15)
    torch.testing.assert_close(j1, a1, atol=1e-6, rtol=0)
    torch.testing.assert_close(j2, a2, atol=1e-6, rtol=0)

    mean = VI.apply_tangent(s2, torch.linspace(-0.02, 0.03, 15,
                                               dtype=torch.float64))
    _, jp = VI.prior_tangent(s2, mean)
    ap = jacfwd(lambda d: VI.prior_tangent(VI.apply_tangent(s2, d),
                                           mean)[0])(z15)
    torch.testing.assert_close(jp, ap, atol=1e-6, rtol=0)

    ad = VI.cam_from_body_tangent(r_cb, t_cb)
    _, jb, _ = VI._reproj_body(s2, obs, r_cb, t_cb, ad, *([FX, FX, CX, CY,
                                                           BF]))

    def reproj(d6):
        s = VI.apply_tangent(s2, torch.cat([d6, z15[6:]]))
        rot, t = VI.cam_pose_from_body(s, r_cb, t_cb)
        pc = obs.pts_w @ rot.T + t
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FX * pc[:, 1] / pc[:, 2] + CY
        return torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                            obs.u_right - (u - BF / pc[:, 2])], 1)
    ab = jacfwd(reproj)(z15[:6])
    torch.testing.assert_close(jb, ab, atol=1e-6 * ab.abs().max().item(),
                               rtol=0)

    rot_cw, t_cw = VI.cam_pose_from_body(s2, r_cb, t_cb)

    def cam_tangent(d6):
        r2, t2, _, _ = VIBA._apply_state_tangent(
            rot_cw[None], t_cw[None], torch.zeros(1, 3, dtype=torch.float64),
            torch.zeros(1, 6, dtype=torch.float64),
            torch.cat([d6, z15[6:]])[None], r_cb, t_cb)
        ri, ti = lie.se3_inverse(rot_cw, t_cw)
        rr, tt = lie.se3_compose(r2[0], t2[0], ri, ti)
        return lie.se3_log(rr, tt)
    torch.testing.assert_close(ad, jacfwd(cam_tangent)(z15[:6]), atol=1e-6,
                               rtol=0)


def _port_map():
    """A map of the port's IMU path: 30 frames of the synthetic room at
    10 fps, 320x240, 300 features, the IMU initialized on the way."""
    w, h = 320, 240
    cam = TS.Camera(fx=FX, fy=FX, cx=CX, cy=CY, width=w, height=h)
    seq = TS.SyntheticSequence(TS.SyntheticWorld(cam, device="cpu"),
                               fps=10.0)
    orb = C.OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    cfg = C.SystemConfig(
        fx=FX, fy=FX, cx=CX, cy=CY, bf=BF, k_max=16, m_max=4096,
        frame=C.FrameConfig(orb=orb, lk_levels=3, cloud_stride=8,
                            cloud_max_pts=1024, bf=BF),
        imu=C.ImuConfig(init_min_kfs=4, init_min_time=0.5))
    fs = extract(seq.frame(0.0)[0], orb)
    voc = TV.build_vocabulary(fs.desc[fs.valid].numpy().view(np.uint32),
                              k=4, levels=2, iters=2, device="cpu")
    slam = SlamSystem(cfg, "cpu", vocab=voc)
    for i in range(30):
        g, d, _ = seq.frame(i / 10.0)
        if i == 0:
            slam.track_rgbd(g, d, 0.0)
        else:
            slam.track_rgbd_inertial(g, d, *seq.imu_between(
                (i - 1) / 10.0, i / 10.0, 32), i / 10.0)
    assert slam.imu.initialized and slam.state.name == "OK"
    return slam


def test_vi_ba_step_on_a_jax_tracker_window():
    slam = _port_map()
    ms_t, imu_t = slam.ms, slam.imu
    ms_j = JM.MapState(*(jnp.asarray(x.numpy()) for x in ms_t))
    jt = JIN.InertialTracker(JIN.ImuConfig(init_min_kfs=4,
                                           init_min_time=0.5))
    jt.kf_order = list(imu_t.kf_order)
    jt.kf_preints = {k: JP.Preintegrated(*(np.asarray(x) for x in p))
                     for k, p in imu_t.kf_preints.items()}
    kw = 8
    slots = jt.contiguous_window(kw)
    assert len(slots) >= 4
    slots_p = np.asarray(slots + [16] * (kw - len(slots)), np.int32)
    valid = np.arange(kw) < len(slots)
    segs = jt.build_segments(list(slots_p))
    mcfg_j = JLM.MappingConfig(fx=FX, fy=FX, cx=CX, cy=CY, bf=BF)
    out_j, _ = JLM.vi_ba_step(ms_j, jnp.asarray(slots_p), jnp.asarray(valid),
                              segs, jnp.asarray(imu_t.r_cb_np),
                              jnp.asarray(imu_t.t_cb_np),
                              jnp.asarray(jt.walk_info, jnp.float32),
                              mcfg_j, kw)
    win = TLM.VIWindow(
        slots=torch.tensor(slots_p).long(), slot_valid=torch.tensor(valid),
        segs=VIBA.ImuSegments(**{
            f: torch.tensor(np.asarray(getattr(segs, f)))
            for f in JSegs._fields}),
        r_cb=imu_t.r_cb, t_cb=imu_t.t_cb, walk_info=imu_t.walk_info_dev)
    out_t, _ = TLM.vi_ba_step(ms_t, win, slam.mcfg)
    for k in slots:
        np.testing.assert_allclose(out_t.kf_t[k].numpy(),
                                   np.asarray(out_j.kf_t[k]), atol=1e-4,
                                   rtol=0)
        assert _rot_err(out_t.kf_rot[k].numpy(),
                        np.asarray(out_j.kf_rot[k])) < 1e-4
        for f in ("kf_vel", "kf_bias"):
            np.testing.assert_allclose(
                getattr(out_t, f)[k].numpy(),
                np.asarray(getattr(out_j, f)[k]), atol=1e-4, rtol=0)
    moved = np.abs(np.asarray(out_j.mp_pos) - ms_t.mp_pos.numpy()).max(1) > 0
    assert moved.sum() > 50
    np.testing.assert_allclose(out_t.mp_pos.numpy()[moved],
                               np.asarray(out_j.mp_pos)[moved], atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(out_t.kf_obs_mp.numpy(),
                                  np.asarray(out_j.kf_obs_mp))
