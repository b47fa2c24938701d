"""The port's optical-flow + ICP path end to end on the reference's OF/ICP
variant scenario (tests/test_e2e_variants.py::run_variant with use_of,
n_of_slots=256, use_icp, icp_min_inliers=100 at 5 fps: 320x240, 300
features, 4 levels, 30 frames). Gates: state OK, ATE < 6 cm (the
reference's own OF gate), optical-flow points appended (> 5), ICP
predictions accepted, and per-frame poses within max(2 cm, the reference's
own ATE) of a JAX SlamSystem run on the first 20 frames. The JAX façade
runs with pkt_max_pending=0 (decisions drained every frame, deterministic
and synchronous like the port). RANSAC draws differ between the packages
(jax.random vs torch.Generator), so poses are compared, not samples."""
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 5.0
N_FRAMES, N_JAX = 30, 20


def _configs():
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              n_of_slots=256)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096, use_of=True, use_icp=True, icp_min_inliers=100)
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


def test_of_icp_path_gates_and_reference_agreement(sequence, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a kernel launcher was called for CPU tensors")
    monkeypatch.setattr(kernels, "lk_level", boom)
    frames, gt = sequence
    jcfg, tcfg = _configs()
    slam = SlamSystem(tcfg, device="cpu")
    assert slam.ms.n_kp == 300 + 256
    early = None
    for i, (t, g, d) in enumerate(frames):
        twc = slam.track_rgbd(g, d, t)
        assert twc.shape == (4, 4) and np.all(np.isfinite(twc))
        if i == N_JAX - 1:
            early = dict(slam.trajectory)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert stats["n_kfs"] >= 2, stats
    assert sum(slam.of_appended) > 5, slam.of_appended
    assert slam.last_frame is not None
    assert slam.last_frame.feat.valid[300:].any()
    assert slam.n_icp_accepted >= 1
    m = ate_rmse(slam.trajectory, gt)
    assert m["ate_rmse"] < 0.06, (m, stats)
    assert rpe(slam.trajectory, gt)["rpe_trans"] < 0.03

    ref = JSlam(jcfg)
    for t, g, d in frames[:N_JAX]:
        ref.track_rgbd(g, d, t)
    ref_traj = ref.trajectory
    bound = max(0.02, ate_rmse(ref_traj, gt[:N_JAX])["ate_rmse"])
    assert len(ref_traj) == N_JAX
    assert sum(int(x) for x in ref.debug_of) > 0
    for t, twc in ref_traj:
        err = np.linalg.norm(early[t][:3, 3] - np.asarray(twc)[:3, 3])
        assert err < bound, (t, err, bound)


def test_icp_carries_textureless_frames():
    """Frames with depth but no texture: the visual inliers collapse, the
    ICP registration holds, so every such frame is ICP-carried: state OK, the
    pose follows the camera, the motion model stays armed, and a keyframe
    without map-point bindings every 0.5 s. (A 40x30-point cloud registers
    coarsely: the ATE bound is 10 cm.)"""
    from geoflowslam_tpu_torch.io import synthetic as TS
    from geoflowslam_tpu_torch.pipeline.system import TrackingState

    w, h = 160, 120
    cfg = C.SystemConfig(
        fx=100.0, fy=100.0, cx=w / 2, cy=h / 2, bf=10.0, k_max=8, m_max=1024,
        use_icp=True, icp_min_inliers=100,
        frame=C.FrameConfig(orb=C.OrbConfig(n_features=200, n_levels=2,
                                            height=h, width=w),
                            lk_levels=2, cloud_stride=4, cloud_max_pts=512,
                            bf=10.0))
    cam = TS.Camera(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2, width=w,
                    height=h)
    seq = TS.SyntheticSequence(TS.SyntheticWorld(cam, device="cpu"), fps=10.0)
    slam = SlamSystem(cfg, device="cpu")
    blank = torch.full((h, w), 128.0)
    gt, kfs = [], []
    for i in range(11):
        t = i / 10.0
        g, d, (r, tc) = seq.frame(t)
        slam.track_rgbd(blank if i >= 3 else g, d, t)
        assert slam.state == TrackingState.OK
        r = r.numpy().astype(np.float64)
        twc = np.eye(4)
        twc[:3, :3] = r.T
        twc[:3, 3] = -r.T @ tc.numpy().astype(np.float64)
        gt.append((t, twc))
        kfs.append(slam.map_stats()["n_kfs"])
    assert slam.n_icp_carried == 8 and slam.n_icp_accepted == 10
    assert slam.has_vel and slam.n_lost == 0
    assert kfs[2] == 1 and kfs[-1] == 3          # cadence KFs at 0.5, 1.0 s
    new_kf = slam.ref_kf
    assert bool((slam.ms.kf_obs_mp[new_kf] == -1).all())
    assert ate_rmse(slam.trajectory, gt)["ate_rmse"] < 0.1
