"""The port's sensor-fusion slice without an IMU against a JAX SlamSystem,
frame by frame, on the scenario of tests/test_e2e_variants.py::run_variant
(320x240, 300 features, 4 levels, k_max 24, m_max 4096, 10 fps, 30
frames, no vocabulary). The JAX façade runs with pkt_max_pending=0: its
decisions are made on each frame before the next, as the port makes them.
Both packages get the same frames (rendered by the JAX package).

* test_g1_of_icp_lidar: the flagship G1 combination, use_of (256 OF
  slots), use_icp (icp_min_inliers 100) and use_lidar, fused in one frame
  step; each KF of a tracked frame takes the staged KF step in both.
* test_odom_world_velocity: use_odom with the trajectory's world-frame
  velocity queued before every frame (set_odom(v, odom_frame=False)).
  Neither package runs a frame through its staged step here (no frame is
  lost), so the samples pile up unread in both queues, as the reference
  leaves them.
* test_odom_staged_after_loss: the same with frames 12 and 13 blank (gray
  flat at 100, depth kept) and no vocabulary: the first blank frame fails
  its fused step and is re-run staged, the frames that start
  RECENTLY_LOST run staged from the start, and each of these predicts
  from the queued odometry and empties the queue. The same frames read
  the queue in both packages (at least two), with the same states.
* test_odom_predict_formula: the port's odometry prediction against the
  reference's formula (geoflowslam_tpu/pipeline/system.py _track_frame)
  written with the JAX package's Lie functions, for camera-frame samples
  rotated by r_odom_cam, world-frame samples and both: within 1e-5.

Gates, both packages: state OK, ATE < 5 cm (the reference's gate); every
frame's returned pose and every exported pose within max(2 cm, the
reference's own ATE) of the reference's; with use_lidar a global map of
more than 500 points in both and valid plane factors on the frames after
the second KF. Optical-flow and registration draws differ between the
packages (jax.random vs torch.Generator), so poses are compared, not
samples.
"""
import dataclasses

import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import (Camera, SyntheticSequence,
                                          SyntheticWorld, smooth_trajectory)
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS, N = 320, 240, 200.0, 10.0, 30


def _configs(n_of_slots=0, **kw):
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              n_of_slots=n_of_slots)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096, **kw)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           **sc))


@pytest.fixture(scope="module")
def sequence():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    frames, gt, vel = [], [], []
    for i in range(N):
        t = i / FPS
        g, d, (r, tc) = seq.frame(t)
        r = np.asarray(r, np.float64)
        twc = np.eye(4)
        twc[:3, :3] = r.T
        twc[:3, 3] = -r.T @ np.asarray(tc, np.float64)
        frames.append((t, np.array(g), np.array(d)))
        gt.append((t, twc))
        vel.append(np.array(smooth_trajectory(np.float32(t))[2]))
    return frames, gt, vel


def _run(slam, sequence, odom=False, blank=()):
    frames, _, vel = sequence
    poses, states, kfs, read = [], [], [], []
    for i, ((t, g, d), v) in enumerate(zip(frames, vel)):
        if odom:
            slam.set_odom(v, odom_frame=False)
        if i in blank:
            g = np.full_like(g, 100.0)
        poses.append(np.asarray(slam.track_rgbd(g, d, t), np.float64))
        states.append(slam.state.name)
        kfs.append(slam.map_stats()["n_kfs"])
        if odom and not slam._odom_queue:
            read.append(i)
    return dict(poses=poses, states=states, kfs=kfs, odom_read=read,
                traj=dict((t, np.asarray(p)) for t, p in slam.trajectory))


def _compare(ref, port, gt):
    ates = {}
    for tag, run in (("reference", ref), ("port", port)):
        assert run["states"][-1] == "OK", (tag, run["states"])
        traj = sorted(run["traj"].items())
        ates[tag] = ate_rmse(traj, gt)["ate_rmse"]
        assert ates[tag] < 0.05, (tag, ates)
    bound = max(0.02, ates["reference"])
    for i, (a, b) in enumerate(zip(ref["poses"], port["poses"])):
        err = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert err < bound, (i, err, bound)
    assert set(port["traj"]) == set(ref["traj"])
    for t, a in ref["traj"].items():
        assert np.linalg.norm(a[:3, 3] - port["traj"][t][:3, 3]) < bound, t
    return ates


def test_g1_of_icp_lidar(sequence):
    kw = dict(n_of_slots=256, use_of=True, use_icp=True, icp_min_inliers=100,
              use_lidar=True)
    jcfg, tcfg = _configs(**kw)
    ref_slam = JSlam(jcfg)
    ref = _run(ref_slam, sequence)
    slam = SlamSystem(tcfg, "cpu")
    assert slam.cfg.frame.lidar_features
    port = _run(slam, sequence)
    ates = _compare(ref, port, sequence[1])
    n_ref, n_port = (len(ref_slam.global_map.points()),
                     len(slam.global_map.points()))
    print(f"ATE reference {ates['reference'] * 100:.3f} cm, port "
          f"{ates['port'] * 100:.3f} cm; global map {n_ref} and {n_port} "
          f"points; KFs {ref['kfs'][-1]} and {port['kfs'][-1]}")
    assert n_ref > 500 and n_port > 500
    assert sum(slam.of_appended) > 5 and slam.n_icp_accepted >= 1
    second_kf = next(i for i, k in enumerate(port["kfs"]) if k >= 2)
    counts = dict(slam.plane_factor_counts)
    after = [counts[round(t, 4)] for t, _, _ in sequence[0][second_kf + 1:]]
    assert after and min(after) > 0, after


def test_odom_world_velocity(sequence):
    jcfg, tcfg = _configs(use_odom=True)
    ref_slam = JSlam(jcfg)
    ref = _run(ref_slam, sequence, odom=True)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, sequence, odom=True)
    ates = _compare(ref, port, sequence[1])
    print(f"ATE reference {ates['reference'] * 100:.3f} cm, port "
          f"{ates['port'] * 100:.3f} cm; queued samples "
          f"{len(ref_slam._odom_queue)} and {len(slam._odom_queue)}")
    assert len(slam._odom_queue) == len(ref_slam._odom_queue)


def test_odom_staged_after_loss(sequence):
    blank = (12, 13)
    jcfg, tcfg = _configs(use_odom=True)
    ref = _run(JSlam(jcfg), sequence, odom=True, blank=blank)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, sequence, odom=True, blank=blank)
    print(f"states {ref['states']} and {port['states']}; odometry read on "
          f"frames {ref['odom_read']} and {port['odom_read']}")
    assert all(ref["states"][i] == "RECENTLY_LOST" for i in blank)
    assert port["states"] == ref["states"]
    assert len(ref["odom_read"]) >= 2 and port["odom_read"] == ref["odom_read"]
    assert slam.n_odom_frames == len(port["odom_read"])
    ates = _compare(ref, port, sequence[1])
    print(f"ATE reference {ates['reference'] * 100:.3f} cm, port "
          f"{ates['port'] * 100:.3f} cm")


def test_odom_predict_formula():
    from geoflowslam_tpu.math import lie as JL
    import jax.numpy as jnp

    rs = np.random.default_rng(3)
    r_odom_cam = tuple(JL.so3_exp(jnp.asarray(rs.normal(size=3) * 0.5,
                                              jnp.float32)).reshape(-1)
                       .tolist())
    _, tcfg = _configs(use_odom=True)
    tcfg = dataclasses.replace(tcfg, r_odom_cam=r_odom_cam)
    for kinds in (("cam",), ("world",), ("cam", "world")):
        slam = SlamSystem(tcfg, "cpu")
        cur = [rs.normal(size=3) * 0.3, rs.normal(size=3)]
        pred = [rs.normal(size=3) * 0.3, rs.normal(size=3)]
        cur_rot, cur_t = (np.array(JL.so3_exp(jnp.asarray(cur[0],
                          jnp.float32))), cur[1].astype(np.float32))
        pr, pt = (np.array(JL.so3_exp(jnp.asarray(pred[0], jnp.float32))),
                  pred[1].astype(np.float32))
        queue = []
        for k in kinds:
            for _ in range(3):
                v = rs.normal(size=3).astype(np.float32)
                slam.set_odom(v, odom_frame=k == "cam")
                queue.append((k, (np.asarray(r_odom_cam, np.float32)
                                  .reshape(3, 3) @ v) if k == "cam" else v))
        slam.cur_rot, slam.cur_t = (torch.from_numpy(cur_rot),
                                    torch.from_numpy(cur_t))
        slam.last_time, ts = 0.4, 0.5
        got = slam._odom_predict(torch.from_numpy(pr), torch.from_numpy(pt),
                                 ts)
        assert not slam._odom_queue and slam.n_odom_frames == 1
        # the reference's formula, geoflowslam_tpu/pipeline/system.py
        dt = max(ts - 0.4, 0.0)
        cam_v = [v for f, v in queue if f == "cam"]
        wld_v = [v for f, v in queue if f == "world"]
        rwc, twc = JL.se3_inverse(jnp.asarray(cur_rot), jnp.asarray(cur_t))
        dpos = jnp.zeros(3)
        if cam_v:
            dpos = dpos + rwc @ (jnp.asarray(np.mean(cam_v, axis=0)) * dt)
        if wld_v:
            dpos = dpos + jnp.asarray(np.mean(wld_v, axis=0)) * dt
        pr2, _ = JL.se3_inverse(jnp.asarray(pr), jnp.asarray(pt))
        want = JL.se3_inverse(pr2, twc + dpos)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0)
