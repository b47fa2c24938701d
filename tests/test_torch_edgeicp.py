"""The EdgeICP factor of the port's VI-BA against the JAX package, and its
closed-form Jacobians against forward-mode AD:

* solvers/inertial_ba.rel_pose_terms' residual e = log(T_meas^-1 T2
  T1^-1) on 20 random pose triples (rotations up to ~0.6 rad, translations
  up to 1 m, measurements near the relative pose) against the reference's
  expression through its own lie functions: within 1e-5;
* its Jacobians in float64 against torch.func.jacfwd: in the camera
  poses' left tangents (exp(xi) T), and in the 15-dim body tangents of
  VI-BA's own state update (_apply_state_tangent, the camera-from-body
  map included): within 1e-6;
* vi_local_ba on one seeded window (5 KFs 0.15 s apart on the synthetic
  trajectory, a camera-IMU extrinsic off the identity, 150 points seen by
  every KF with 0.5 px noise, 10% of the observations missing, poses 1 cm
  and 0.3 deg and velocities 5 cm/s off, the JAX preintegration of the
  200 Hz samples) with RelPoseFactors: one row with information 1e2 whose
  measurement is the true relative pose moved by 5 cm, one row with a far
  wrong measurement and zero information, two absent rows. Poses within
  1e-4 m and 1e-4 rad of the JAX vi_local_ba, velocities and biases
  within 1e-4, points within 1e-4 m; once at the reference's weight 1e2
  (beside 150 points a KF and the IMU the factor moves the poses by a few
  micrometres) and once at 1e5, where it is seen to work: without it the
  port's poses differ by more than 1e-4 m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.imu import preintegration as JP
from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.pipeline import inertial as JIN
from geoflowslam_tpu.solvers import inertial_ba as JBA
from geoflowslam_tpu.solvers import local_ba as JLB

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.solvers import inertial as VI
from geoflowslam_tpu_torch.solvers import inertial_ba as VIBA
from geoflowslam_tpu_torch.solvers import local_ba as TLB

torch.set_num_threads(2)

FX, CX, CY, BF = 200.0, 160.0, 120.0, 20.0
K, M = 5, 150
T0, DT = 1.0, 0.15


def _rand_pose(rs, rot_scale, t_scale):
    r = np.asarray(JL.so3_exp(jnp.asarray(rs.randn(3) * rot_scale,
                                          jnp.float32)))
    return r.astype(np.float32), (rs.randn(3) * t_scale).astype(np.float32)


def _triples(n=20):
    rs = np.random.RandomState(11)
    out = []
    for _ in range(n):
        r1, t1 = _rand_pose(rs, 0.35, 1.0)
        r2, t2 = _rand_pose(rs, 0.35, 1.0)
        rr = r2 @ r1.T
        tr = t2 - rr @ t1
        dr, dt = _rand_pose(rs, 0.05, 0.05)
        out.append((r1, t1, r2, t2, (dr @ rr).astype(np.float32),
                    (tr + dt).astype(np.float32)))
    return [np.stack(x) for x in zip(*out)]


def test_edge_icp_residual_matches_reference():
    r1, t1, r2, t2, mr, mt = _triples()
    ej = []
    for i in range(len(r1)):
        a = [jnp.asarray(x[i]) for x in (r1, t1, r2, t2, mr, mt)]
        ri, ti = JL.se3_inverse(a[0], a[1])
        rr, tr = JL.se3_compose(a[2], a[3], ri, ti)
        mi, mti = JL.se3_inverse(a[4], a[5])
        ej.append(np.asarray(JL.se3_log(*JL.se3_compose(mi, mti, rr, tr))))
    e, _, _ = VIBA.rel_pose_terms(*(torch.from_numpy(x) for x in
                                    (r1, t1, r2, t2, mr, mt)))
    assert np.abs(np.stack(ej)).max() > 0.05
    np.testing.assert_allclose(e.numpy(), np.stack(ej), atol=1e-5, rtol=0)


def test_edge_icp_jacobians_match_forward_ad():
    from torch.func import jacfwd
    r1, t1, r2, t2, mr, mt = (torch.from_numpy(x).double()
                              for x in _triples())
    _, j1, j2 = VIBA.rel_pose_terms(r1, t1, r2, t2, mr, mt)
    z6 = torch.zeros(6, dtype=torch.float64)
    for i in range(len(r1)):
        def left(xi, which):
            dr, dt = lie.se3_exp(xi)
            a = (r1[i], t1[i], r2[i], t2[i])
            if which == 1:
                a = lie.se3_compose(dr, dt, a[0], a[1]) + a[2:]
            else:
                a = a[:2] + lie.se3_compose(dr, dt, a[2], a[3])
            return VIBA.rel_pose_terms(*a, mr[i], mt[i])[0]
        torch.testing.assert_close(j1[i], jacfwd(lambda x: left(x, 1))(z6),
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(j2[i], jacfwd(lambda x: left(x, 2))(z6),
                                   atol=1e-6, rtol=0)

    # in VI-BA's body tangents, through its own state update
    r_cb, t_cb = (torch.from_numpy(x).double() for x in _rand_pose(
        np.random.RandomState(3), 0.03, 0.05))
    ad = VI.cam_from_body_tangent(r_cb, t_cb)
    z15 = torch.zeros(15, dtype=torch.float64)
    zv, zb = torch.zeros(1, 3).double(), torch.zeros(1, 6).double()
    for i in range(len(r1)):
        def body(d, which):
            a = [r1[i], t1[i], r2[i], t2[i]]
            k = 0 if which == 1 else 2
            rot, t, _, _ = VIBA._apply_state_tangent(
                a[k][None], a[k + 1][None], zv, zb, d[None], r_cb, t_cb)
            a[k], a[k + 1] = rot[0], t[0]
            return VIBA.rel_pose_terms(*a, mr[i], mt[i])[0]
        for which, jc in ((1, j1[i]), (2, j2[i])):
            want = torch.cat([jc @ ad, torch.zeros(6, 9).double()], 1)
            torch.testing.assert_close(
                want, jacfwd(lambda d: body(d, which))(z15), atol=1e-6,
                rtol=0)


def _t_bc():
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.asarray(JL.so3_exp(jnp.array([0.02, -0.03, 0.01])))
    t[:3, 3] = [0.05, -0.02, 0.03]
    return t


@pytest.fixture(scope="module")
def window():
    rs = np.random.RandomState(7)
    cfg = JIN.ImuConfig(t_bc=_t_bc())
    calib = cfg.calib()
    r_bc, t_bc = _t_bc()[:3, :3], _t_bc()[:3, 3]
    r_cb = r_bc.T.astype(np.float32)
    t_cb = (-r_bc.T @ t_bc).astype(np.float32)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(JS.Camera()), fps=30.0)
    ts = T0 + DT * np.arange(K)
    bias = np.zeros(6, np.float32)
    jt = JIN.InertialTracker(cfg)
    jt.kf_preints = {i: JP.preintegrate(*seq.imu_between(ts[i - 1], ts[i],
                                                          32),
                                        jnp.asarray(bias), calib)
                     for i in range(1, K)}
    segs = jt.build_segments(list(range(K)))
    rot, tr, vel = [], [], []
    for i, t in enumerate(ts):
        rot_wc, p, v, *_ = (np.asarray(x, np.float64) for x in
                            JS.smooth_trajectory(jnp.float32(t)))
        r_wb = rot_wc @ r_cb
        p_wb = rot_wc @ t_cb + p
        r_bw = r_wb.T
        rc, tc = r_cb @ r_bw, r_cb @ (-r_bw @ p_wb) + t_cb
        rot.append(rc)
        tr.append(tc)
        vel.append(v)
    rot, tr, vel = np.stack(rot), np.stack(tr), np.stack(vel)
    # observations at the true poses
    centre = -rot[K // 2].T @ tr[K // 2]
    pts = centre + (rot[K // 2].T @ np.stack([
        rs.uniform(-1.5, 1.5, M), rs.uniform(-1.0, 1.0, M),
        rs.uniform(1.5, 4.0, M)])).T
    pc = np.einsum("kij,mj->kmi", rot, pts) + tr[:, None]
    uv = np.stack([FX * pc[..., 0] / pc[..., 2] + CX,
                   FX * pc[..., 1] / pc[..., 2] + CY], -1)
    uv = uv + rs.randn(K, M, 2) * 0.5
    stereo = rs.rand(K, M) < 0.5
    ur = np.where(stereo, uv[..., 0] - BF / pc[..., 2], -1.0)
    # the ICP measurement of segment 1: the true relative pose, 5 cm off
    rel_r = rot[2] @ rot[1].T
    rel_t = tr[2] - rel_r @ tr[1] + np.array([0.05, 0.0, 0.0])
    m_rot = np.stack([np.eye(3)] * (K - 1))
    m_t = np.zeros((K - 1, 3))
    m_rot[1], m_t[1] = rel_r, rel_t
    m_rot[2] = np.asarray(JL.so3_exp(jnp.array([0.4, 0.2, -0.3])))
    m_t[2] = [0.5, -0.3, 0.2]
    info = np.array([0.0, 1e2, 0.0, 0.0])
    # start: poses (but the first, fixed) and velocities off the truth
    for i in range(1, K):
        dr, dt = _rand_pose(rs, np.radians(0.3) / np.sqrt(3), 0.006)
        rot[i], tr[i] = dr @ rot[i], tr[i] + dt
        vel[i] = vel[i] + rs.randn(3) * 0.03
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    vis = dict(kf_rot=f32(rot), kf_t=f32(tr),
               kf_fixed=np.arange(K) == 0, kf_valid=np.ones(K, bool),
               pts=f32(pts + rs.randn(M, 3) * 0.01),
               pt_valid=np.ones(M, bool), uv=f32(uv), u_right=f32(ur),
               is_stereo=stereo, inv_sigma2=np.ones((K, M), np.float32),
               obs_valid=rs.rand(K, M) < 0.9)
    return dict(vis=vis, vel=f32(vel), bias=np.zeros((K, 6), np.float32),
                segs=segs, r_cb=r_cb, t_cb=t_cb, walk_info=f32(jt.walk_info),
                icp=dict(rot=f32(m_rot), t=f32(m_t), info=f32(info)))


def _jax_problem(w):
    return JBA.VIBAProblem(
        vis=JLB.BAProblem(**{k: jnp.asarray(v) for k, v in w["vis"].items()}),
        kf_vel=jnp.asarray(w["vel"]), kf_bias=jnp.asarray(w["bias"]),
        segs=JBA.ImuSegments(*(jnp.asarray(x) for x in w["segs"])),
        r_cb=jnp.asarray(w["r_cb"]), t_cb=jnp.asarray(w["t_cb"]),
        walk_info=jnp.asarray(w["walk_info"]),
        icp=JBA.RelPoseFactors(**{k: jnp.asarray(v)
                                  for k, v in w["icp"].items()}))


def _port_problem(w, icp=True):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return VIBA.VIBAProblem(
        vis=TLB.BAProblem(**{k: t(v) for k, v in w["vis"].items()}),
        kf_vel=t(w["vel"]), kf_bias=t(w["bias"]),
        segs=VIBA.ImuSegments(*(t(x) for x in w["segs"])),
        r_cb=t(w["r_cb"]), t_cb=t(w["t_cb"]), walk_info=t(w["walk_info"]),
        icp=VIBA.RelPoseFactors(**{k: t(v) for k, v in w["icp"].items()})
        if icp else None)


def _rot_err(a, b):
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(2.0 * np.arcsin(min(d / np.sqrt(8.0), 1.0)))


_JAX_VI_BA = jax.jit(JBA.vi_local_ba, static_argnums=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("info", [1e2, 1e5])
def test_vi_local_ba_with_edge_icp(window, info):
    w = dict(window, icp=dict(window["icp"]))
    w["icp"]["info"] = window["icp"]["info"] * np.float32(info / 1e2)
    out_j, _ = _JAX_VI_BA(_jax_problem(w), FX, FX, CX, CY, BF)
    out_t, _ = VIBA.vi_local_ba(_port_problem(w), FX, FX, CX, CY, BF)
    for i in range(K):
        np.testing.assert_allclose(out_t.vis.kf_t[i].numpy(),
                                   np.asarray(out_j.vis.kf_t[i]), atol=1e-4,
                                   rtol=0)
        assert _rot_err(out_t.vis.kf_rot[i].numpy(),
                        np.asarray(out_j.vis.kf_rot[i])) < 1e-4
    np.testing.assert_allclose(out_t.kf_vel.numpy(), np.asarray(out_j.kf_vel),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_t.kf_bias.numpy(),
                               np.asarray(out_j.kf_bias), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_t.vis.pts.numpy(),
                               np.asarray(out_j.vis.pts), atol=1e-4, rtol=0)
    free, _ = VIBA.vi_local_ba(_port_problem(w, icp=False), FX, FX, CX, CY,
                               BF)
    moved = float((free.vis.kf_t - out_t.vis.kf_t).abs().max())
    print(f"info {info:g}: the EdgeICP row moved the poses by {moved:.2e} m")
    if info > 1e2:
        assert moved > 1e-4
