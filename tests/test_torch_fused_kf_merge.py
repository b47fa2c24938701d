"""The Atlas break and merge of tests/test_e2e_loop.py (320x240, 300
features, k_max 32, LoopConfig(min_sim3_inliers=15, min_score=0.02,
run_global_ba=True), 22 frames, 8 blank frames, 12 frames revisiting the
first views) on the default fused path of both packages (the JAX façade
with pkt_max_pending=0): case (c) of tests/test_torch_fused_kf.py, whose
scene (the room and the vocabulary JAX builds from three of its frames)
it shares. With the fused KF step the loop detection of a KF is acted on
`fused_lag` processed frames after it, or at the next forced drain
(map_stats, a staged frame), in both packages.
"""
import numpy as np

from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline import loop_closing as JLC
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from tests.test_torch_fused_kf import (CPU, FPS, FX, H, W, _host,  # noqa
                                       scene)


def _merge_configs():
    loop = dict(min_sim3_inliers=15, min_score=0.02, run_global_ba=True)
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=32,
              m_max=4096, kf_min_interval=1, kf_max_interval=2,
              time_recently_lost=0.25, min_kfs_for_new_map=6)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 loop=JLC.LoopConfig(**loop), **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           loop=C.LoopConfig(**loop), **sc))


def _merge_drive(slam, frames):
    """tests/test_e2e_loop.py's staging: 22 frames, 8 blank ones, 12
    revisiting phase A's views; map_stats where it reads it. Returns the
    frames whose loop check closed a loop or merged, the stats, the KF
    share of the active map and the exported trajectory."""
    lc = slam.loop_closer
    complete, closed, frame_no = lc.complete_candidate, [], [0]

    def record(*a, **k):
        out = complete(*a, **k)
        if out[1]:
            closed.append(frame_no[0])
        return out
    lc.complete_candidate = record
    for i in range(22):
        frame_no[0] = i
        slam.track_rgbd(*frames[i][1:3], i / FPS)
    st_a = slam.map_stats()
    blank = np.full((H, W), 100.0, np.float32)
    bdepth = np.full((H, W), 2.0, np.float32)
    for i in range(8):
        frame_no[0] = 22 + i
        slam.track_rgbd(blank, bdepth, 2.2 + i / FPS)
    st_b = slam.map_stats()
    for i in range(12):
        frame_no[0] = 30 + i
        slam.track_rgbd(*frames[i][1:3], 3.2 + i / FPS)
    st = slam.map_stats()
    valid = _host(slam.ms.kf_valid).astype(bool)
    share = float((_host(slam.ms.kf_map_id)[valid]
                   == int(_host(slam.ms.active_map))).mean())
    traj = dict((round(t, 4), np.asarray(p)) for t, p in slam.trajectory)
    return dict(closed=closed, stats=(st_a, st_b, st), share=share,
                traj=traj, n=lc.n_loops + lc.n_merges)


def test_atlas_merge_on_the_fused_path_matches_the_reference(scene):
    """(c): both packages meet tests/test_e2e_loop.py's gates, close their
    first loop or merge on the same processed frame, end with the same map
    count, and the tracked frames' exported poses agree within max(2 cm,
    the reference's ATE)."""
    frames, voc = scene
    jcfg, tcfg = _merge_configs()
    ref = _merge_drive(JSlam(jcfg, vocab=voc), frames)
    port = _merge_drive(
        SlamSystem(tcfg, CPU, vocab=convert.vocabulary(voc, CPU)), frames)
    for run in (ref, port):
        st_a, st_b, st = run["stats"]
        assert st_a["n_kfs"] >= 6 and st_b["n_maps"] >= 2, run["stats"]
        assert st["state"] == "OK" and run["n"] >= 1, run["stats"]
        assert run["share"] > 0.9, run["share"]
    assert ref["closed"] and port["closed"][0] == ref["closed"][0], (
        ref["closed"], port["closed"])
    assert port["stats"][2]["n_maps"] == ref["stats"][2]["n_maps"]
    gt = {round(t, 4): frames[i][3] for i, t in enumerate(
        [i / FPS for i in range(22)])}
    gt.update({round(3.2 + i / FPS, 4): frames[i][3] for i in range(12)})
    rt, pt = ref["traj"], port["traj"]
    common = sorted(set(rt) & set(pt) & set(gt))
    assert len(common) >= 28, (len(rt), len(pt))
    bound = max(0.02, ate_rmse([(t, rt[t]) for t in common],
                               [(t, gt[t]) for t in common])["ate_rmse"])
    for t in common:
        assert np.linalg.norm(rt[t][:3, 3] - pt[t][:3, 3]) < bound, t
