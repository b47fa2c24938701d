"""The port's IMU preintegration, its copy of the IMU initialization solvers,
the initialization on a map, apply_scaled_rotation and the IMU options of
the façade's config check, against the JAX package on the same seeded
inputs:

* preintegrate (32 samples, some rows padding, with a bias), reintegrate
  with another bias, merge_previous and predict_state: dR, dV and dP within
  1e-5 relative to their size (dR entries absolutely), the bias Jacobians
  within 1e-5 of their size, the covariance within 1e-4 of its largest
  entry, the prediction within 1e-5 m, m/s and rad;
* a KF segment over 1.4 s of 200 Hz samples (over the 512-sample capacity,
  so the tracker's pair decimation runs) from the JAX InertialTracker and
  the port's, to the same tolerances;
* imu/init_np.py against geoflowslam_tpu/imu/init_np.py on a 10-KF window
  of the synthetic trajectory: every solver's output within 1e-9 (the same
  float64 code);
* InertialTracker.try_initialize on the same map and segments, imu_method 0
  and 2: the gravity-aligned, rescaled KF poses and the velocities within
  1e-5, the bias within 1e-5 (method 0) or within 1e-3 of its largest
  entry (method 2: its least-squares accelerometer-bias solve amplifies
  the two float32 preintegrations' ~1e-7 differences about a hundredfold);
  then reinitialize with a free scale and scale_refinement (the mono
  re-runs) on the initialized maps: the maps within 1e-4, the same
  outcomes;
* apply_scaled_rotation on a random map within 1e-5;
* check_config accepts imu with use_icp, use_of or both, with the
  monocular sensor (also with use_odom or use_icp) and with
  local_ba_every_kf=False, SlamSystem takes
  imu without a vocabulary or with record_reproj_err (the staged step), and
  SlamSystem(cfg with imu, device="cuda") raises without CUDA.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.imu import init_np as JNI
from geoflowslam_tpu.imu import preintegration as JP
from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.pipeline import inertial as JIN
from geoflowslam_tpu.state import map_state as JM

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.imu import init_np as TNI
from geoflowslam_tpu_torch.imu import preintegration as TP
from geoflowslam_tpu_torch.pipeline import inertial as TIN
from geoflowslam_tpu_torch.pipeline.system import SlamSystem, check_config
from geoflowslam_tpu_torch.state import map_state as TM

torch.set_num_threads(2)

CFG = C.ImuConfig()
J_CALIB = JIN.ImuConfig().calib()
T_CALIB = CFG.calib()


def _samples(rs, n, n_valid, dt=0.005):
    acc = (rs.randn(n, 3) * 0.5 + [0.0, 0.0, 9.81]).astype(np.float32)
    gyro = (rs.randn(n, 3) * 0.4).astype(np.float32)
    dts = np.where(np.arange(n) < n_valid, dt, 0.0).astype(np.float32)
    return acc, gyro, dts


def _check_preint(pj, pt):
    """dR/dV/dP 1e-5 relative, Jacobians 1e-5, covariance 1e-4."""
    np.testing.assert_allclose(float(pt.dt), float(pj.dt), rtol=1e-6)
    np.testing.assert_allclose(pt.dR, np.asarray(pj.dR), atol=1e-5, rtol=0)
    for f in ("dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f)
        np.testing.assert_allclose(
            b, a, atol=1e-5 * max(np.abs(a).max(), 1e-3), rtol=0, err_msg=f)
    cj = np.asarray(pj.cov)
    np.testing.assert_allclose(pt.cov, cj, atol=1e-4 * np.abs(cj).max(),
                               rtol=0)
    np.testing.assert_array_equal(pt.bias, np.asarray(pj.bias))


def test_preintegrate_reintegrate_merge_predict():
    rs = np.random.RandomState(0)
    acc, gyro, dts = _samples(rs, 32, 27)
    bias = (rs.randn(6) * 0.02).astype(np.float32)
    pj = JP.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                         jnp.asarray(dts), jnp.asarray(bias), J_CALIB)
    pt = TP.preintegrate(acc, gyro, dts, bias, T_CALIB)
    _check_preint(pj, pt)

    bias2 = (bias + rs.randn(6) * 0.01).astype(np.float32)
    _check_preint(JP.reintegrate(pj, jnp.asarray(bias2), J_CALIB),
                  TP.reintegrate(pt, bias2, T_CALIB))

    acc_b, gyro_b, dts_b = _samples(rs, 32, 19)
    pj_b = JP.preintegrate(jnp.asarray(acc_b), jnp.asarray(gyro_b),
                           jnp.asarray(dts_b), jnp.asarray(bias2), J_CALIB)
    pt_b = TP.preintegrate(acc_b, gyro_b, dts_b, bias2, T_CALIB)
    _check_preint(JP.merge_previous(pj, pj_b, J_CALIB),
                  TP.merge_previous(pt, pt_b, T_CALIB))

    rot = JS.smooth_trajectory(jnp.float32(1.3))[0]
    t_wb = np.array([0.3, -0.2, 1.1], np.float32)
    v = np.array([0.4, 0.1, -0.2], np.float32)
    bias3 = (bias + rs.randn(6) * 0.005).astype(np.float32)
    rj, tj, vj = JP.predict_state(rot, jnp.asarray(t_wb), jnp.asarray(v), pj,
                                  jnp.asarray(bias3))
    rt, tt, vt = TP.predict_state(
        torch.tensor(np.asarray(rot)), torch.from_numpy(t_wb),
        torch.from_numpy(v), TP.to_device(pt, "cpu"),
        torch.from_numpy(bias3))
    for a, b in ((rj, rt), (tj, tt), (vj, vt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)


def test_kf_segment_with_decimation():
    """280 frames' worth of 7-sample chunks (1960 samples) fold into one
    512-sample segment by two pair-merge passes in both trackers."""
    rs = np.random.RandomState(1)
    jt = JIN.InertialTracker(JIN.ImuConfig())
    tt = TIN.InertialTracker(CFG, "cpu")
    bias = (rs.randn(6) * 0.01).astype(np.float32)
    jt.bias_host = bias
    tt.bias = bias
    for k in range(280):
        acc, gyro, dts = _samples(rs, 32, 7)
        jt._chunks.append((acc, gyro, dts, 0.1 * k))
        tt._chunks.append((acc, gyro, dts, 0.1 * k))
    stacked_j, stacked_t = jt._stack_chunks_np(), tt._stack_chunks_np()
    for a, b in zip(stacked_j, stacked_t):
        np.testing.assert_array_equal(a, b)
    assert (stacked_t[2] > 0).sum() == 490
    jt.on_keyframe(3, upto_ts=20.0)
    tt.on_keyframe(3, upto_ts=20.0)
    assert jt.kf_order == tt.kf_order == [3]
    assert len(jt._chunks) == len(tt._chunks) == 79
    _check_preint(jt.kf_preints[3], tt.kf_preints[3])


def _window(n_kf=10, dt_kf=0.5, t0=0.4):
    """KF states and host segments of the synthetic trajectory: (times,
    R_wb, p_wb, JAX preints, port preints)."""
    seq = JS.SyntheticSequence(JS.SyntheticWorld(JS.Camera()), fps=10.0)
    times = t0 + dt_kf * np.arange(n_kf)
    rot, p, *_ = [np.asarray(x, np.float64) for x in JS.smooth_trajectory(
        jnp.asarray(times, jnp.float32))]
    pj, pt = [], []
    for i in range(n_kf - 1):
        acc, gyro, dts = (np.asarray(x) for x in seq.imu_between(
            times[i], times[i + 1], 512))
        pj.append(jax_tree_np(JP.preintegrate(
            jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
            jnp.zeros(6), J_CALIB)))
        pt.append(TP.preintegrate(acc, gyro, dts, np.zeros(6, np.float32),
                                  T_CALIB))
    return times, rot, p, pj, pt


def jax_tree_np(p):
    return JP.Preintegrated(*(np.asarray(x) for x in p))


def test_init_np_copy_matches():
    times, rot, p, pj, _ = _window()
    dts = np.array([float(x.dt) for x in pj])
    d_r = np.stack([x.dR for x in pj])
    jrg = np.stack([x.JRg for x in pj])
    d_v = np.stack([x.dV for x in pj])
    d_p = np.stack([x.dP for x in pj])
    jpa = np.stack([x.JPa for x in pj])
    jva = np.stack([x.JVa for x in pj])
    cases = [
        ("solve_gyro_bias_np", (rot, d_r, jrg), {}),
        ("solve_gravity_scale_velocities_np", (rot, p, dts, d_v, d_p), {}),
        ("solve_gravity_scale_velocities_np", (rot, p, dts, d_v, d_p),
         dict(solve_scale=True)),
        ("solve_accelerometer_analytic_np",
         (rot, p, dts, d_v, d_p, jpa, jva), {}),
        ("solve_accelerometer_analytic_np",
         (rot, p, dts, d_v, d_p, jpa, jva), dict(solve_scale=True)),
        ("solve_scale_refinement_np",
         (rot, p, dts, d_v, d_p, np.zeros((len(rot), 3))), {}),
        ("gravity_alignment_rotation_np", (np.array([0.3, -0.2, -9.7]),),
         {}),
    ]
    for name, args, kw in cases:
        a = getattr(JNI, name)(*args, **kw)
        b = getattr(TNI, name)(*args, **kw)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, atol=1e-9, rtol=0,
                                       err_msg=name)


def _map_pair(times, rot_wb, p_wb, k_max=16):
    """A JAX MapState holding the window KFs at their camera poses (camera
    = body) and the port's conversion of it."""
    ms = JM.create(k_max, 32, 64)
    n = len(times)
    r_cw = np.swapaxes(rot_wb, 1, 2).astype(np.float32)
    t_cw = -np.einsum("nij,nj->ni", r_cw, p_wb).astype(np.float32)
    ms = ms._replace(
        kf_rot=ms.kf_rot.at[:n].set(r_cw), kf_t=ms.kf_t.at[:n].set(t_cw),
        kf_valid=ms.kf_valid.at[:n].set(True),
        kf_time=ms.kf_time.at[:n].set(jnp.asarray(times, jnp.float32)),
        mp_pos=jnp.asarray(np.random.RandomState(2).randn(64, 3),
                           jnp.float32),
        mp_valid=jnp.ones((64,), bool))
    return ms, convert.map_state(ms, "cpu")


@pytest.mark.parametrize("method", [0, 2])
def test_try_initialize_on_a_map(method):
    times, rot, p, pj, pt = _window()
    ms_j, ms_t = _map_pair(times, rot, p)
    jt = JIN.InertialTracker(JIN.ImuConfig(init_min_kfs=4, imu_method=method))
    tt = TIN.InertialTracker(C.ImuConfig(init_min_kfs=4, imu_method=method),
                             "cpu")
    for k in range(len(times)):
        for tr, pre in ((jt, pj), (tt, pt)):
            tr.kf_order.append(k)
            if k > 0:
                tr.kf_preints[k] = pre[k - 1]
    ms_j, did_j = jt.try_initialize(ms_j)
    ms_t, did_t = tt.try_initialize(ms_t)
    assert did_j and did_t
    for f in ("kf_rot", "kf_t", "kf_vel", "mp_pos"):
        np.testing.assert_allclose(getattr(ms_t, f).numpy(),
                                   np.asarray(getattr(ms_j, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
    bias_j = np.asarray(jt.bias)
    tol = 1e-5 if method == 0 else 1e-3 * np.abs(bias_j).max()
    np.testing.assert_allclose(tt.bias, bias_j, atol=tol, rtol=0)
    np.testing.assert_allclose(ms_t.kf_bias.numpy(), np.asarray(ms_j.kf_bias),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(tt.last_transform[0],
                               np.asarray(jt.last_transform[0]), atol=1e-5)
    assert bool(ms_t.imu_initialized)
    # the metric velocities of the smooth trajectory come back
    assert np.abs(ms_t.kf_vel[:10].numpy()).max() < 1.0

    # the mono re-runs on the initialized map: VIBA's re-initialization
    # with a free scale, then the scale refinement
    ms_j, did_j = jt.reinitialize(ms_j, scale_free=True)
    ms_t, did_t = tt.reinitialize(ms_t, scale_free=True)
    assert did_j == did_t
    ms_j, ms_t = jt.scale_refinement(ms_j), tt.scale_refinement(ms_t)
    assert (jt.last_transform is None) == (tt.last_transform is None)
    for f in ("kf_rot", "kf_t", "kf_vel", "mp_pos"):
        np.testing.assert_allclose(getattr(ms_t, f).numpy(),
                                   np.asarray(getattr(ms_j, f)), atol=1e-4,
                                   rtol=0, err_msg=f)


def test_apply_scaled_rotation():
    rs = np.random.RandomState(4)
    ms = JM.create(8, 16, 32)
    r = np.asarray(JS.smooth_trajectory(jnp.float32(2.0))[0])
    ms = ms._replace(
        kf_rot=jnp.asarray(np.tile(r, (8, 1, 1))),
        kf_t=jnp.asarray(rs.randn(8, 3), jnp.float32),
        kf_vel=jnp.asarray(rs.randn(8, 3), jnp.float32),
        kf_valid=jnp.asarray(rs.rand(8) > 0.3),
        kf_map_id=jnp.asarray(rs.randint(0, 2, 8), jnp.int32),
        mp_pos=jnp.asarray(rs.randn(32, 3), jnp.float32),
        mp_valid=jnp.asarray(rs.rand(32) > 0.3),
        mp_map_id=jnp.asarray(rs.randint(0, 2, 32), jnp.int32))
    r_gw = np.asarray(JS.smooth_trajectory(jnp.float32(5.0))[0])
    out_j = JM.apply_scaled_rotation(ms, jnp.asarray(r_gw), 1.3)
    out_t = TM.apply_scaled_rotation(convert.map_state(ms, "cpu"),
                                     torch.from_numpy(r_gw), 1.3)
    for f in ("kf_rot", "kf_t", "kf_vel", "mp_pos"):
        np.testing.assert_allclose(getattr(out_t, f).numpy(),
                                   np.asarray(getattr(out_j, f)), atol=1e-5,
                                   rtol=0, err_msg=f)


def test_imu_config_checks():
    base = C.SystemConfig(imu=C.ImuConfig())
    for ok in (dict(use_icp=True), dict(use_of=True),
               dict(use_icp=True, use_of=True), dict(sensor="mono"),
               dict(local_ba_every_kf=False)):
        check_config(dataclasses.replace(base, **ok))
    for ok in (dict(sensor="mono", use_odom=True),
               dict(sensor="mono", use_icp=True)):
        cfg = dataclasses.replace(base, **ok)
        check_config(cfg)
        assert SlamSystem(dataclasses.replace(cfg, k_max=4, m_max=64, frame=C.FrameConfig(orb=C.OrbConfig(
            n_features=50, n_levels=2, height=64, width=64))),
                          "cpu").imu is not None
    check_config(base)
    # the staged IMU step is ported: no vocabulary, or record_reproj_err
    for cfg in (base, dataclasses.replace(base, record_reproj_err=True)):
        assert SlamSystem(cfg, "cpu").imu is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SlamSystem(base, "cuda")
