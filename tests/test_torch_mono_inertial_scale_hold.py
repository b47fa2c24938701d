"""The port's counterpart of tests/test_mono_inertial_scale_hold.py (slow
tier): 64 s of mono-inertial SLAM on the port's synthetic room
time-warped by freq 2.5 (accelerations near 1 m/s^2: metric scale is
observable only under excitation), 320x240 at 5 fps, on the CPU, with the
reference's gates unchanged: state OK, the IMU initialized, > 90% of the
frames tracked, the Sim3 alignment scale within 5% of 1 over the post-init
early window and over the late half, at most 4% of drift between them,
and the 6-DoF ATE over the last 2/5 under 15 cm.

The initializer gets the reference's RANSAC draws (PRNGKey(1234), as
tests/test_torch_slice_mono.py hands them over), so that the port's run is
the reference's run ported. With the port's own draws the two-view init
lands elsewhere and the track is lost soon after the IMU initialization
(the mono-inertial chaos of ROADMAP Queue 1 item 1).

This test fails on its drift gate, as the reference's own test does on
the same machine: the port reads 1.020 early and 0.975 late (4.51% of
drift), the JAX package 1.011 and 0.956 (5.47%). Past the init the 64 s
horizon turns small differences into a few percent of scale (ROADMAP
Queue 3, reference traits)."""
import numpy as np
import pytest
import torch

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.io.synthetic import (Camera, SyntheticSequence,
                                                SyntheticWorld)
from geoflowslam_tpu_torch.ops import ransac as TR
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from test_torch_slice_mono import JaxInitDraws

torch.set_num_threads(2)


@pytest.mark.slow
def test_mono_inertial_scale_hold_60s(monkeypatch):
    w, h, fps, n_frames = 320, 240, 5.0, 320
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    cfg = C.SystemConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=0.0,
        frame=C.FrameConfig(orb=C.OrbConfig(n_features=400, n_levels=4,
                                            height=h, width=w),
                            lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                            bf=0.0),
        k_max=96, m_max=16384, sensor="mono", min_inliers_ok=12,
        imu=C.ImuConfig(init_min_kfs=5, init_min_time=0.8))
    seq = SyntheticSequence(SyntheticWorld(cam, device="cpu"), fps=fps,
                            scale=1.2, freq=2.5)
    monkeypatch.setattr(TR, "_sample_minimal_sets", JaxInitDraws())
    slam = SlamSystem(cfg, "cpu")
    gt, last_t = [], 0.0
    for i in range(n_frames):
        t = i / fps
        gray, _, (rot_cw, t_cw) = seq.frame(t)
        if i == 0:
            slam.track_monocular(gray, t)
        else:
            slam.track_monocular_inertial(
                gray, *seq.imu_between(last_t, t, 64), t)
        last_t = t
        rwc = rot_cw.numpy().astype(np.float64).T
        twc = np.eye(4)
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ t_cw.numpy().astype(np.float64)
        gt.append((t, twc))

    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam.imu.initialized, stats
    traj = slam.trajectory
    n = len(traj)
    assert n > n_frames * 0.9, n
    early, late = slice(n // 5, n // 2), slice(n // 2, n)
    m_early = ate_rmse(traj[early], gt[early], with_scale=True)
    m_late = ate_rmse(traj[late], gt[late], with_scale=True)
    assert abs(m_early["scale"] - 1.0) < 0.05, (m_early, stats)
    assert abs(m_late["scale"] - 1.0) < 0.05, (m_late, stats)
    assert abs(m_late["scale"] - m_early["scale"]) < 0.04, (m_early, m_late)
    tail = n * 2 // 5
    m6 = ate_rmse(traj[-tail:], gt[-tail:], with_scale=False)
    assert m6["ate_rmse"] < 0.15, (m6, stats)
