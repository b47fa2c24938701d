"""The port's RGB-D-inertial slice against a JAX SlamSystem on its default
path (pkt_max_pending=0: synchronous, as the other slice tests run it), on
the scenario of tests/test_e2e_inertial.py (320x240, 400 features, 4
levels, 10 fps, k_max 24, ImuConfig(init_min_kfs=4, init_min_time=0.5),
200 Hz IMU samples, the first frame through track_rgbd), with a vocabulary
of the scene built from three of its frames (as test_torch_slice_hard.py
builds one) and, after the IMU initializes, 8 blank frames (0.8 s: gray
flat at 100, depth kept) before the normal frames come back. Both packages
get the same frames and samples; both dead-reckon through the blank
frames, insert a keyframe while lost, and recover.

Gates: the IMU initialized on the same frame and the same state on every
frame; every frame's returned pose (the dead-reckoned ones included), and
every exported pose, within max(2 cm, the reference's own ATE) of the
reference's; the final velocity within 0.05 m/s; the initialization's
gravity alignment within 0.5 deg and its scale within 1%; ATE over the
frames after the initialization < 5 cm in both packages (the reference's
gate, tests/test_e2e_inertial.py:54-62); a keyframe inserted while lost in
both.
"""
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS, N = 320, 240, 200.0, 10.0, 50
BLANK = range(20, 28)


def _configs():
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096)
    imu = dict(init_min_kfs=4, init_min_time=0.5)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 imu=JImu(**imu), **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(**imu), **sc))


@pytest.fixture(scope="module")
def scene():
    cam = JS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=FPS)
    frames, imu, gt = [], [None], []
    for i in range(N):
        t = i / FPS
        g, d, (rot_cw, t_cw) = seq.frame(t)
        g, d = np.array(g), np.array(d)
        if i in BLANK:
            g = np.full_like(g, 100.0)
        frames.append((g, d))
        if i > 0:
            imu.append(tuple(np.array(x) for x in seq.imu_between(
                (i - 1) / FPS, t, 32)))
        twc = np.eye(4)
        twc[:3, :3] = np.asarray(rot_cw, np.float64).T
        twc[:3, 3] = -twc[:3, :3] @ np.asarray(t_cw, np.float64)
        gt.append((t, twc))
    orb = C.OrbConfig(n_features=400, n_levels=4, height=H, width=W)
    desc = []
    for i in (0, 15, 40):
        fs = extract(torch.from_numpy(frames[i][0]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    return frames, imu, gt, voc


def _run(slam, scene):
    frames, imu, gt, _ = scene
    transforms = []
    consume = slam._consume_imu_transform

    def spy():
        transforms.append(slam.imu.last_transform)
        return consume()
    slam._consume_imu_transform = spy
    poses, states, init, kf_lost = [], [], None, 0
    for i, ((g, d), (t, _)) in enumerate(zip(frames, gt)):
        last_kf = slam._last_kf_time
        if i == 0:
            twc = slam.track_rgbd(g, d, t)
        else:
            twc = slam.track_rgbd_inertial(g, d, *imu[i], t)
        assert np.all(np.isfinite(np.asarray(twc)))
        poses.append(np.asarray(twc))
        states.append(slam.state.name)
        if init is None and slam.imu.initialized:
            init = i
        kf_lost += (slam.state.name == "RECENTLY_LOST"
                    and slam._last_kf_time != last_kf)
    return dict(poses=poses, states=states, init=init, kf_lost=kf_lost,
                transforms=[x for x in transforms if x is not None],
                traj=dict((t, np.asarray(p)) for t, p in slam.trajectory),
                v=np.asarray(slam.imu.body.v), stats=slam.map_stats())


@pytest.fixture(scope="module")
def reference(scene):
    return _run(JSlam(_configs()[0], vocab=scene[3]), scene)


@pytest.fixture(scope="module")
def port(scene):
    slam = SlamSystem(_configs()[1], "cpu",
                      vocab=convert.vocabulary(scene[3], "cpu"))
    return _run(slam, scene)


def test_inertial_slice_tracks_the_reference(scene, reference, port):
    gt = scene[2]
    assert reference["init"] is not None and port["init"] == reference["init"]
    assert port["states"] == reference["states"]
    assert all(reference["states"][i] == "RECENTLY_LOST" for i in BLANK)
    assert reference["states"][-1] == "OK" and port["stats"]["n_maps"] == 1
    assert port["kf_lost"] >= 1 and reference["kf_lost"] >= 1

    after = [e for e in gt if e[0] > reference["init"] / FPS]
    ates = {}
    for tag, run in (("reference", reference), ("port", port)):
        traj = [(t, run["traj"][t]) for t, _ in after if t in run["traj"]]
        ates[tag] = ate_rmse(traj, after)["ate_rmse"]
        assert ates[tag] < 0.05, (tag, ates)
    bound = max(0.02, ates["reference"])
    for i, (a, b) in enumerate(zip(reference["poses"], port["poses"])):
        err = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert err < bound, (i, err, bound)
    assert set(port["traj"]) == set(reference["traj"])
    for t, a in reference["traj"].items():
        assert np.linalg.norm(a[:3, 3] - port["traj"][t][:3, 3]) < bound, t

    np.testing.assert_allclose(port["v"], reference["v"], atol=0.05, rtol=0)
    assert len(port["transforms"]) == len(reference["transforms"]) == 1
    (r_p, s_p), (r_r, s_r) = port["transforms"][0], reference["transforms"][0]
    d = np.linalg.norm(np.asarray(r_p, np.float64)
                       - np.asarray(r_r, np.float64))
    assert np.degrees(2 * np.arcsin(d / np.sqrt(8.0))) < 0.5
    assert abs(s_p / s_r - 1.0) < 0.01
