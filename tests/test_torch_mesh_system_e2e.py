"""SlamSystem(..., mesh=LandMesh(["cpu"] * 8)) end to end beside the JAX
package's SlamSystem(mesh=...) on its 8-device virtual CPU mesh (slow
tier): tests/test_mesh_system_e2e.py's scenario (320x240, 300 features, a
vocabulary JAX builds from three frames, LoopConfig(run_global_ba=True,
async_global_ba=True)): build a map, lose it on blank frames, revisit and
merge. Each package runs it with and without the mesh.

Gates on the port: both runs OK with a merge or a loop, the mesh run's
asynchronous global BA stepped on the mesh; and its trajectory within
MESH_RMS_BOUND of the run without a mesh (RMS over their common stamps).
The reference's own bound, 2 cm (tests/test_mesh_system_e2e.py:90), fails
in the JAX package on the CPU: 0.84 m in its own test, 1.30 and 2.39 m in
two runs of this one (the reference's runs differ from process to
process, the port's do not), so the port's bound is set from its own
deterministic reading instead. Its sharded step is Gauss-Newton without the
single-device step's 1e-3 diagonal and re-gating, and on the freshly
merged map it keeps moving the KFs: up to 18, 38, 41, 48 and 64 cm after
1, 2, 3, 5 and 10 iterations in the port, where the single-device global
BA moves them 28 cm. The port reads 25 cm; MESH_RMS_BOUND gives it 5 cm
of headroom, a fifth of the reading. The two packages' mesh runs
are not compared pose by pose: past that step they part by metres (in
one reference run its mesh run closed a second loop and ended
RECENTLY_LOST). The step itself is held to JAX's on the merged loop-slice
state within 1 mm (tests/test_torch_slice_loop.py)."""
import jax
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.ops.extractor import extract as jextract
from geoflowslam_tpu.pipeline.loop_closing import LoopConfig as JLoop
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.parallel.dist_ba import LandMesh
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H = 320, 240
MESH_RMS_BOUND = 0.30   # m; the port reads 0.25 m, the same in every run


def _configs():
    cam = dict(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2)
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(bf=20.0, k_max=32, m_max=4096, kf_min_interval=1,
              kf_max_interval=2, time_recently_lost=0.25,
              min_kfs_for_new_map=6, **cam)
    lp = dict(min_sim3_inliers=15, min_score=0.02, run_global_ba=True,
              async_global_ba=True)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), loop=JLoop(**lp),
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           loop=C.LoopConfig(**lp), **sc))


def _drive(slam, seq):
    blank = np.full((H, W), 100.0, np.float32)
    bdepth = np.full((H, W), 2.0, np.float32)
    for i in range(22):                       # build a map
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        slam.track_rgbd(np.array(gray), np.array(depth), t)
    for i in range(8):                        # lost -> new map
        slam.track_rgbd(blank, bdepth, 2.2 + i / seq.fps)
    for i in range(16):                       # revisit -> merge
        gray, depth, _ = seq.frame(i / seq.fps)
        slam.track_rgbd(np.array(gray), np.array(depth), 3.2 + i / seq.fps)
    lc = slam.loop_closer
    return dict(stats=slam.map_stats(), events=(lc.n_loops, lc.n_merges),
                traj={round(t, 4): np.asarray(m)[:3, 3]
                      for t, m in slam.trajectory}, slam=slam)


def _rms(a, b):
    common = sorted(set(a) & set(b))
    assert len(common) >= 30, len(common)
    d = np.array([a[t] - b[t] for t in common])
    return float(np.sqrt((d ** 2).sum(1).mean()))


@pytest.mark.slow
def test_mesh_system_against_reference():
    cam = Camera(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=10.0)
    orb = JOrb(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for t in (0.0, 0.7, 1.4):
        fs = jextract(seq.frame(t)[0], orb)
        desc.append(np.asarray(fs.desc)[np.asarray(fs.valid)])
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    jcfg, tcfg = _configs()
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("land",))
    ref_m = _drive(JSlam(jcfg, vocab=voc, mesh=jmesh), seq)
    ref_s = _drive(JSlam(jcfg, vocab=voc), seq)
    tvoc = convert.vocabulary(voc, "cpu")
    mesh = LandMesh(["cpu"] * 8)
    port_m = _drive(SlamSystem(tcfg, "cpu", vocab=tvoc, mesh=mesh), seq)
    port_s = _drive(SlamSystem(tcfg, "cpu", vocab=tvoc), seq)
    rms = dict(ref=_rms(ref_m["traj"], ref_s["traj"]),
               port=_rms(port_m["traj"], port_s["traj"]))
    print("RMS to the run without a mesh", rms, "reference mesh run",
          ref_m["stats"], ref_m["events"])
    for run in (port_m, port_s):
        assert run["stats"]["state"] == "OK", run["stats"]
        assert sum(run["events"]) >= 1, run["stats"]
    g = port_m["slam"]._gba
    assert g.mesh is mesh and g.i >= 1
    assert rms["port"] < MESH_RMS_BOUND, rms
