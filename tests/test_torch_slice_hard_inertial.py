"""Slow tier: the port's RGB-D-inertial slice on the hard-mode sequence
against a JAX SlamSystem on its default path with decisions made on each
frame (pkt_max_pending=0, as the port makes them): the first 300 frames
(10 s at 30 fps: the IMU initialization, the fast-rotation bursts and the
start of the first texture-poor window) at 320x240, 300 features, 4
levels, m12 buffers from the hard-mode script's pre-render, epoch
timestamps (t0 = 1.4e9 s), 200 Hz IMU samples (ImuConfig(), the hard-mode
script's), a vocabulary of the scene built from three frames (as
test_torch_slice_hard.py builds one). Both packages take the same buffers
and samples.

Gates: the IMU initialized on the same frame, the same state on every
frame, every returned pose within max(2 cm, the reference's own ATE) of
the reference's. Prints the largest pose distance (run with -s). About
400 s on the CPU, most of it the JAX reference.
"""
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.io.feed_codec import unpack_m12_np
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.tools import run_hardmode as HM

torch.set_num_threads(2)

W, H, FX, FPS, N, T0 = 320, 240, 200.0, 30.0, 300, 1.4e9


def _configs():
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              feed_codec="m12")
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=64,
              m_max=8192)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 imu=JImu(), **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(), **sc))


def _run(slam, bufs, imu, ts):
    poses, states, init = [], [], None
    for i in range(N):
        if i == 0:
            twc = slam.track_rgbd(bufs[i], None, T0 + ts[i])
        else:
            twc = slam.track_rgbd_inertial(bufs[i], None, *imu[i],
                                           T0 + ts[i])
        poses.append(np.asarray(twc))
        states.append(slam.state.name)
        if init is None and slam.imu.initialized:
            init = i
    return poses, states, init, slam.trajectory


@pytest.mark.slow
def test_hard_inertial_slice_tracks_the_reference():
    cam = TS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = TS.HardSyntheticSequence(TS.SyntheticWorld(cam, device="cpu"),
                                   fps=FPS)
    ts = np.arange(N) / FPS
    rot_cw, t_cw, _ = HM.ground_truth(seq, ts)
    bufs = HM.prerender(seq, rot_cw, t_cw, ts)
    imu = [None] + [tuple(x.numpy() for x in seq.imu_between(
        ts[i - 1], ts[i], 32)) for i in range(1, N)]
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for i in (0, 30, 60):
        g, _ = unpack_m12_np(bufs[i], H, W)
        fs = extract(torch.from_numpy(g.astype(np.float32)), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    ref = _run(JSlam(_configs()[0], vocab=voc), bufs, imu, ts)
    port = _run(SlamSystem(_configs()[1], "cpu",
                           vocab=convert.vocabulary(voc, "cpu")),
                bufs, imu, ts)
    assert ref[2] is not None and port[2] == ref[2]
    assert port[1] == ref[1]
    # the reference's own ATE, on its exported trajectory (rewritten into
    # the gravity-aligned world at the initialization)
    gt = []
    for t, r, tt in zip(ts, rot_cw, t_cw):
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ tt
        gt.append((T0 + t, m))
    ate = ate_rmse(ref[3], gt)
    bound = max(0.02, ate["ate_rmse"])
    dist = [np.linalg.norm(a[:3, 3] - b[:3, 3])
            for a, b in zip(ref[0], port[0])]
    print(f"init frame {ref[2]}, reference ATE {ate['ate_rmse']:.4f} m, "
          f"largest pose distance {max(dist):.4f} m at frame "
          f"{int(np.argmax(dist))}, states not OK: "
          f"{[i for i, s in enumerate(ref[1]) if s != 'OK']}")
    assert max(dist) < bound, (int(np.argmax(dist)), max(dist), bound)
