"""The port's slice on the hard-mode sequence: the first 90 frames (3 s at
30 fps, into the first contrast drop) of HardSyntheticSequence at 320x240,
300 features, 4 levels, fed as m12 buffers that the hard-mode script's
pre-render packs (tools/run_hardmode.py), epoch timestamps (t0 = 1.4e9 s),
with the scene's own vocabulary (JAX builds it from three frames, as
tests/test_torch_slice_loop.py does). The port and a JAX SlamSystem on its
default path (pkt_max_pending=0, synchronous, as tests/test_torch_slice.py
runs it) take the same buffers. Gates: both OK with 1 map at the end; the
port's pose on every frame within max(2 cm, the reference's own ATE) of the
reference's; the same count of KF-stall warnings.
"""
import dataclasses

import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.io.feed_codec import unpack_m12_np
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.tools import run_hardmode as HM
from test_torch_shared import shared_result

torch.set_num_threads(2)

W, H, FX, FPS, N, T0 = 320, 240, 200.0, 30.0, 90, 1.4e9


def _configs():
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              feed_codec="m12")
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=32,
              m_max=4096)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           **sc))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The m12 buffers, ground truth and vocabulary, once per session for
    every xdist worker (tests/test_torch_shared.py)."""
    return shared_result(tmp_path_factory, "test_torch_slice_hard.scene",
                         _scene)


def _scene():
    cam = TS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = TS.HardSyntheticSequence(TS.SyntheticWorld(cam, device="cpu"),
                                   fps=FPS)
    ts = np.arange(N) / FPS
    rot_cw, t_cw, twc = HM.ground_truth(seq, ts)
    bufs = HM.prerender(seq, rot_cw, t_cw, ts)
    gt = [(T0 + t, twc[i]) for i, t in enumerate(ts)]
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for i in (0, 30, 60):
        g, _ = unpack_m12_np(bufs[i], H, W)
        fs = extract(torch.from_numpy(g.astype(np.float32)), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    return bufs, gt, voc


def _run(slam, bufs, gt):
    for (t, _), buf in zip(gt, bufs):
        twc = slam.track_rgbd(buf, None, t)
        assert np.all(np.isfinite(np.asarray(twc)))
    return dict(stats=slam.map_stats(),
                traj=dict((t, np.asarray(p)) for t, p in slam.trajectory),
                stalls=slam.kf_stall_warnings, slam=slam)


@pytest.fixture(scope="module")
def reference(scene):
    bufs, gt, voc = scene
    return _run(JSlam(_configs()[0], vocab=voc), bufs, gt)


@pytest.fixture(scope="module")
def port(scene):
    bufs, gt, voc = scene
    slam = SlamSystem(_configs()[1], "cpu",
                      vocab=convert.vocabulary(voc, "cpu"))
    assert slam._fused_mode()
    return _run(slam, bufs, gt)


def test_hard_slice_tracks_the_reference(scene, reference, port):
    _, gt, _ = scene
    for run in (reference, port):
        assert run["stats"]["state"] == "OK", run["stats"]
        assert run["stats"]["n_maps"] == 1, run["stats"]
    bound = max(0.02, ate_rmse(list(reference["traj"].items()), gt)[
        "ate_rmse"])
    m = ate_rmse(list(port["traj"].items()), gt)
    assert m["ate_rmse"] < 0.05 and rpe(list(port["traj"].items()), gt)[
        "rpe_trans"] < 0.03, m
    common = sorted(set(reference["traj"]) & set(port["traj"]))
    assert len(common) >= N - 5, (len(reference["traj"]), len(port["traj"]))
    for t in common:
        err = np.linalg.norm(reference["traj"][t][:3, 3]
                             - port["traj"][t][:3, 3])
        assert err < bound, (t - T0, err, bound)
    assert port["stalls"] == reference["stalls"] == 0
    # the Track_total stage timer saw every frame, New_KF every KF after
    # the first
    samples = port["slam"].timers.samples
    assert len(samples["Track_total"]) == N
    assert 1 <= len(samples["New_KF"]) <= port["stats"]["n_kfs"] + 8


@pytest.mark.parametrize("staged", [False, True])
def test_kf_frame_keeps_its_bindings_and_its_record(scene, staged):
    """Two things the reference's frame step does on a keyframe frame, and
    the port does too: the next frame tracks from the frame's own tracked
    bindings (not the KF's bindings after mapping), and the frame's pose is
    recorded against the reference KF it was tracked against, before the
    KF's mapping step. The staged path (record_reproj_err) keeps the
    reference's staged KF step: the KF's live bindings after mapping, and
    the pose recorded against the new KF."""
    bufs, gt, voc = scene
    cfg = dataclasses.replace(_configs()[1], record_reproj_err=staged)
    slam = SlamSystem(cfg, "cpu", vocab=convert.vocabulary(voc, "cpu"))
    assert slam._fused_mode() is not staged
    seen = []
    insert = slam._insert_keyframe

    def spy(frame, t, res, n):
        seen.append((t, res.obs_mp.clone(), slam.ref_kf,
                     slam._kf_gen[slam.ref_kf]))
        return insert(frame, t, res, n)
    slam._insert_keyframe = spy
    for (t, _), buf in zip(gt[:40], bufs[:40]):
        slam.track_rgbd(buf, None, t)
        if seen and seen[-1][0] == t:
            entry = slam._traj[-1]
            assert entry[0] == t and slam.ref_kf != seen[-1][2]
            if staged:
                obs = slam.ms.kf_obs_mp[slam.ref_kf]
                live = (obs >= 0) & slam.ms.mp_valid[obs.clamp_min(0).long()]
                assert torch.equal(slam.last_obs_mp,
                                   torch.where(live, obs, -1))
                assert entry[2:4] == (slam.ref_kf,
                                      slam._kf_gen[slam.ref_kf])
            else:
                assert torch.equal(slam.last_obs_mp, seen[-1][1])
                assert entry[2:4] == seen[-1][2:4]
    assert len(seen) >= 2
