"""The port's RGB-D slice end to end on the test_e2e_rgbd scenario (320x240,
400 features, 4 levels, 40 frames at 10 fps): state OK, ATE < 5 cm and
RPE < 3 cm (the reference's gates), and per-frame poses within
max(2 cm, the reference's own ATE) of a JAX SlamSystem run on the same
first 20 frames. The JAX façade defers keyframe decisions to a reader
thread, so its keyframe timing depends on wall-clock pacing; the reference
runs here with pkt_max_pending=0, which drains its decision ring after every
frame: deterministic, and synchronous like the port's façade."""
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
N_FRAMES, N_JAX = 40, 20


def _configs():
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24, m_max=4096)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           **sc))


@pytest.fixture(scope="module")
def sequence():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    frames, gt = [], []
    for i in range(N_FRAMES):
        t = i / FPS
        g, d, (r, tc) = seq.frame(t)
        r = np.asarray(r, np.float64)
        twc = np.eye(4)
        twc[:3, :3] = r.T
        twc[:3, 3] = -r.T @ np.asarray(tc, np.float64)
        frames.append((t, np.array(g), np.array(d)))
        gt.append((t, twc))
    return frames, gt


def test_slice_gates_and_reference_agreement(sequence):
    frames, gt = sequence
    jcfg, tcfg = _configs()
    slam = SlamSystem(tcfg, device="cpu")
    early = None
    for i, (t, g, d) in enumerate(frames):
        twc = slam.track_rgbd(g, d, t)
        assert twc.shape == (4, 4) and np.all(np.isfinite(twc))
        if i == N_JAX - 1:
            early = dict(slam.trajectory)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert stats["n_kfs"] >= 2, stats
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.05, (m, stats)
    assert rpe(slam.trajectory, gt)["rpe_trans"] < 0.03

    ref = JSlam(jcfg)
    for t, g, d in frames[:N_JAX]:
        ref.track_rgbd(g, d, t)
    ref_traj = ref.trajectory
    bound = max(0.02, ate_rmse(ref_traj, gt[:N_JAX])["ate_rmse"])
    assert len(ref_traj) == N_JAX
    for t, twc in ref_traj:
        err = np.linalg.norm(early[t][:3, 3] - np.asarray(twc)[:3, 3])
        assert err < bound, (t, err, bound)


def test_lost_reset_and_reinit():
    """Textureless frames: OK -> RECENTLY_LOST -> LOST after
    time_recently_lost -> reinitialization on the next textured frame; lost
    frames are not exported; a timestamp going backwards resets the map."""
    from geoflowslam_tpu_torch.io import synthetic as TS
    from geoflowslam_tpu_torch.pipeline.system import TrackingState

    w, h = 160, 120
    cfg = C.SystemConfig(
        fx=100.0, fy=100.0, cx=w / 2, cy=h / 2, bf=10.0, k_max=8, m_max=1024,
        frame=C.FrameConfig(orb=C.OrbConfig(n_features=200, n_levels=2,
                                            height=h, width=w),
                            lk_levels=2, cloud_stride=8, cloud_max_pts=256,
                            bf=10.0))
    cam = TS.Camera(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2, width=w, height=h)
    seq = TS.SyntheticSequence(TS.SyntheticWorld(cam, device="cpu"), fps=10.0)
    slam = SlamSystem(cfg, device="cpu")
    states = []
    for t in (0.0, 0.1, 0.2):
        g, d, _ = seq.frame(t)
        slam.track_rgbd(g, d, t)
        states.append(slam.state)
    assert states[-1] == TrackingState.OK
    blank = torch.full((h, w), 128.0)
    depth = torch.full((h, w), 2.0)
    for t in (0.5, 1.0, 3.0, 5.4, 5.8):
        slam.track_rgbd(blank, depth, t)
        states.append(slam.state)
    assert states[3] == TrackingState.RECENTLY_LOST
    assert states[-1] == TrackingState.NOT_INITIALIZED  # LOST, then reset
    g, d, _ = seq.frame(6.0)
    slam.track_rgbd(g, d, 6.0)
    assert slam.state == TrackingState.OK
    stamps = [t for t, _ in slam.trajectory]
    assert 0.5 not in stamps and 1.0 not in stamps and 6.0 in stamps
    assert slam.n_lost == 5
    n_maps = slam.map_stats()["n_maps"]
    with pytest.warns(UserWarning, match="older"):
        slam.track_rgbd(g, d, 5.9)
    assert slam.map_stats()["n_maps"] == n_maps + 1
