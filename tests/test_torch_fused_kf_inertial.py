"""An RGB-D-inertial frame that fails the fused step without a vocabulary,
in the port against a JAX SlamSystem (pkt_max_pending=0, no vocabulary),
on the inertial slice's scenario (tests/test_torch_slice_inertial.py:
320x240, 400 features, 10 fps, ImuConfig(init_min_kfs=4,
init_min_time=0.5), 200 Hz samples) with its blank frames from frame 24,
0.5 s after the last KF.

The first blank frame fails the fused step. The reference re-runs it
through its staged step from the outputs it has already adopted: the VI
state and prior cleared, the bias the frame preintegration's, and the
dead-reckoned body predicted over the same gap a second time; the re-run
loses the frame too and inserts a KF at that prediction
(InsertKFsWhenLost), which is the pose it records. The frames after it
start RECENTLY_LOST and take the staged step. Held: the same states on
every frame, one staged re-run, and the failed frame's recorded pose and
the pose of its KF (as inserted, before later VI-BA windows move it)
within 0.2 mm and 0.05 deg of the reference's. The CPU reads 1.6e-5 m and
0.022 deg for the recorded pose; the fused step's own single prediction,
which the port took before, is 2.9 mm and 0.11 deg away.
"""
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS, N = 320, 240, 200.0, 10.0, 30
BLANK = range(24, 30)
POS_TOL, ROT_TOL_DEG = 2e-4, 0.05


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
    frames, imu = [], [None]
    for i in range(N):
        g, d, _ = seq.frame(i / FPS)
        g, d = np.array(g), np.array(d)
        if i in BLANK:
            g = np.full_like(g, 100.0)
        frames.append((g, d))
        if i > 0:
            imu.append(tuple(np.array(x) for x in seq.imu_between(
                (i - 1) / FPS, i / FPS, 32)))
    return frames, imu


def _pose(rot, t):
    return np.asarray(rot, np.float64), np.asarray(t, np.float64)


def _run(slam, scene):
    frames, imu = scene
    states, lost_kfs = [], []
    for i, (g, d) in enumerate(frames):
        gens = dict(slam._kf_gen)
        t = i / FPS
        if i == 0:
            slam.track_rgbd(g, d, t)
        else:
            slam.track_rgbd_inertial(g, d, *imu[i], t)
        states.append(slam.state.name)
        new = [s for s, gen in slam._kf_gen.items() if gens.get(s) != gen]
        if slam.state.name == "RECENTLY_LOST" and new:
            s = new[0]
            lost_kfs.append((i, _pose(np.asarray(slam.ms.kf_rot[s]),
                                      np.asarray(slam.ms.kf_t[s]))))
    rec = {round(e[0], 6): np.asarray(e[1], np.float64) for e in slam._traj}
    return dict(states=states, lost_kfs=lost_kfs, recorded=rec,
                init=slam.imu.initialized)


@pytest.fixture(scope="module")
def reference(scene):
    return _run(JSlam(_configs()[0]), scene)


@pytest.fixture(scope="module")
def port(scene):
    slam = SlamSystem(_configs()[1], "cpu")
    out = _run(slam, scene)
    out["reruns"] = slam.n_staged_reruns
    return out


def _rot_deg(a, b):
    c = (np.trace(a @ b.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def test_failed_imu_frame_is_rerun_as_the_reference_reruns_it(reference,
                                                             port):
    assert reference["init"] and port["init"]
    assert port["states"] == reference["states"]
    b0 = BLANK[0]
    assert reference["states"][b0 - 1] == "OK"
    assert reference["states"][b0] == "RECENTLY_LOST"
    assert port["reruns"] == 1
    t0 = round(b0 / FPS, 6)
    a, b = reference["recorded"][t0], port["recorded"][t0]
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < POS_TOL
    assert _rot_deg(a[:3, :3], b[:3, :3]) < ROT_TOL_DEG
    assert reference["lost_kfs"] and port["lost_kfs"]
    (fa, (ra, ta)), (fb, (rb, tb)) = reference["lost_kfs"][0], port[
        "lost_kfs"][0]
    assert fa == fb == BLANK[0], (fa, fb)
    assert np.linalg.norm(ta - tb) < POS_TOL
    assert _rot_deg(ra, rb) < ROT_TOL_DEG
