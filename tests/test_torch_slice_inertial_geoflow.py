"""The port's RGB-D-inertial path with GeoFlow's streams against a JAX
SlamSystem, frame by frame, on the scenario of
tests/test_e2e_variants.py::test_icp_inertial_edgeicp (320x240, 300
features, 4 levels, 10 fps, k_max 24, m_max 4096,
ImuConfig(init_min_kfs=4, init_min_time=0.5), use_icp with
icp_min_inliers 100, 200 Hz IMU samples, the first frame through
track_rgbd, 35 frames). The port's IMU path needs a vocabulary; both get
one built from three frames of the scene (as
tests/test_torch_slice_inertial.py builds it), and the JAX façade runs
with pkt_max_pending=0, so both take their default (fused) path and
decide on each frame before the next. Each case runs the port, then
takes the JAX package's run of it: the three tier-1 cases' JAX runs are
made one after another in one process, once per session, and shared by
the xdist workers (tests/test_torch_shared.py). They run the same JAX
programs: in one process the first run pays the compiles (~135 s of its
~150 s) and the others reuse them. That process is a fresh one
(test_torch_shared.fresh_process): under `--dist load`, workers that had
run many tests before died reading these programs from JAX's persistent
compilation cache.

* test_icp_inertial_edgeicp: use_icp beside the IMU: the ICP predictor
  from the IMU prediction and the inter-KF registrations that become
  EdgeICP factors of VI-BA;
* test_icp_carried_inertial: the same over 50 frames, of which frames
  20-27 (0.8 s after the IMU initializes) have their gray image flat at
  100 and keep their depth. The visual track collapses on those frames
  while the frame-to-frame registration holds, so both packages carry
  them: state OK at the registered pose, the motion model learning the
  registered delta, the body state dead-reckoned, the VI marginal kept,
  and a KF without bindings every 0.5 s whose registration against the
  previous KF becomes an EdgeICP measurement. Besides the gates below:
  the same state on every frame, every blank frame OK (carried) in both,
  the port's carried count at least the window's length, a KF inside the
  window at the same time in both, the final body velocity within 0.05
  m/s;
* test_lidar_inertial: the 35 frames with use_lidar added. Every frame
  refines its pose against the sliding local map before the VI
  refinement, and every KF of a tracked frame takes the staged KF step,
  also after the IMU has initialized (the KF stamped with its body
  velocity and bias, VI-BA in the staged local BA, the host-gated
  inter-KF registration, which keeps only a registration that passed its
  gate: none passes on this room in either package, so both EdgeICP logs
  stay empty). Besides the gates below: the same state on every frame,
  staged KF steps after the initialization at the same timestamps in
  both (at least one), a global map of more than 500 points in both, and
  valid plane factors on every frame after the second KF in the port;
* test_icp_of_inertial_edgeicp: use_icp and use_of with 256 OF slots
  (slow tier: the reference's compiles of its OF variants put the file
  past 250 s on one worker).

Gates: the IMU initialized on the same frame in both; the same EdgeICP
measurements, by KF (its insertion number), with the same previous KF and
the same gate outcome (with use_lidar both may be empty); state OK in
both; every frame's returned pose and every exported pose within max(2
cm, the reference's own ATE over the second half) of the reference's;
ATE over the second half < 5 cm in both (the reference's gate); with
use_of, optical-flow points appended.
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
from test_torch_shared import fresh_process, shared_result

torch.set_num_threads(2)

W, H, FX, FPS, N = 320, 240, 200.0, 10.0, 35
CARRIED_N, CARRIED_BLANK = 50, range(20, 28)   # test_icp_carried_inertial


def _configs(n_of_slots=0, **kw):
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              n_of_slots=n_of_slots)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096, use_icp=True, icp_min_inliers=100, **kw)
    imu = dict(init_min_kfs=4, init_min_time=0.5)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 imu=JImu(**imu), **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(**imu), **sc))


def _scene(n=N, blank=()):
    """Frames, IMU samples, ground truth and a vocabulary of the room; the
    frames in `blank` have their gray image flat at 100 (depth kept)."""
    cam = JS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=FPS)
    frames, imu, gt = [], [None], []
    for i in range(n):
        t = i / FPS
        g, d, (rot_cw, t_cw) = seq.frame(t)
        g, d = np.array(g), np.array(d)
        if i in blank:
            g = np.full_like(g, 100.0)
        frames.append((g, d))
        if i > 0:
            imu.append(tuple(np.array(x) for x in seq.imu_between(
                (i - 1) / FPS, t, 32)))
        twc = np.eye(4)
        twc[:3, :3] = np.asarray(rot_cw, np.float64).T
        twc[:3, 3] = -twc[:3, :3] @ np.asarray(t_cw, np.float64)
        gt.append((t, twc))
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for i in (0, 15, 30):
        fs = extract(torch.from_numpy(frames[i][0]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    return frames, imu, gt, voc


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _shared(tmp_path_factory, "scene", _scene)


def _carried_scene():
    return _scene(n=CARRIED_N, blank=CARRIED_BLANK)


def _shared(tmp_path_factory, name, compute):
    return shared_result(tmp_path_factory,
                         f"test_torch_slice_inertial_geoflow.{name}", compute)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """references(case): the JAX package's run of a tier-1 case
    ("edgeicp", "carried" or "lidar"); a case asks for it once its port
    run is done (a worker that waits for another to make them has done
    its own part first)."""
    def compute():
        base = _shared(tmp_path_factory, "scene", _scene)
        carried = _shared(tmp_path_factory, "carried_scene", _carried_scene)
        return fresh_process(_jax_references, base, carried)
    return lambda case: _shared(tmp_path_factory, "references", compute)[case]


def _jax_references(base, carried):
    return dict(edgeicp=_jax_run(base, {})[0],
                carried=_jax_run(carried, {})[0], lidar=_jax_lidar(base))


def _jax_lidar(scene):
    """The JAX run with use_lidar, the staged KF steps after the IMU
    initialized logged, and its global map's size."""
    names = ("_insert_keyframe", "_insert_keyframe_fused")
    saved = {name: getattr(JSlam, name) for name in names}
    try:
        staged = _spy_staged_kfs(JSlam, *names)
        lidar, ref_slam = _jax_run(scene, dict(use_lidar=True))
    finally:
        for name, fn in saved.items():
            setattr(JSlam, name, fn)
    lidar.update(staged=staged, n_global=len(ref_slam.global_map.points()))
    return lidar


def _log_edges(slam, log):
    """Log each inter-KF registration the frame it appears, by KF: its
    insertion number (generation) -> (the previous KF's, the gate). The
    two packages may place a KF in another slot (the reference frees a
    culled KF's slot a few frames late), and a slot recycled later renames
    the previous KF of an old entry, hence the log at creation. A
    host-gated entry of the reference has passed its gate."""
    gen = slam._kf_gen
    for k, v in slam._kf_icp_rel.items():
        log.setdefault(gen[int(k)], (gen[int(v[2])], bool(np.asarray(v[3]))
                                     if len(v) > 3 else True))


def _run(slam, scene):
    frames, imu, gt, _ = scene
    poses, states, init, edges, kf_times = [], [], None, {}, []
    for i, ((g, d), (t, _)) in enumerate(zip(frames, gt)):
        if i == 0:
            twc = slam.track_rgbd(g, d, t)
        else:
            twc = slam.track_rgbd_inertial(g, d, *imu[i], t)
        _log_edges(slam, edges)
        poses.append(np.asarray(twc, np.float64))
        states.append(slam.state.name)
        kf_times.append(slam._last_kf_time)
        if init is None and slam.imu.initialized:
            init = i
    return dict(poses=poses, states=states, init=init, edges=edges,
                kf_times=kf_times, v=np.asarray(slam.imu.body.v),
                traj=dict((t, np.asarray(p)) for t, p in slam.trajectory))


def _jax_run(scene, kw):
    """The JAX package's run over `scene`: (its _run record, the system)."""
    jcfg, _ = _configs(**kw)
    ref_slam = JSlam(jcfg, vocab=scene[3])
    return _run(ref_slam, scene), ref_slam


def _check(scene, kw, get_ref, edges=True):
    """Run the port over `scene` and hold it to the reference's run that
    get_ref() returns (the gates of the module docstring; with `edges`
    False the EdgeICP logs may both be empty); returns the reference's
    run, the port's run and system."""
    _, tcfg = _configs(**kw)
    slam = SlamSystem(tcfg, "cpu", vocab=convert.vocabulary(scene[3], "cpu"))
    port = _run(slam, scene)
    ref = get_ref()
    gt = scene[2]
    print(f"IMU init at frame {ref['init']} and {port['init']}; EdgeICP "
          f"measurements {ref['edges']} and {port['edges']}")
    assert ref["init"] is not None and port["init"] == ref["init"]
    assert (ref["edges"] or not edges) and port["edges"] == ref["edges"]
    assert ref["states"][-1] == "OK" and port["states"][-1] == "OK"
    tail = gt[-(len(gt) // 2):]
    ates = {}
    for tag, run in (("reference", ref), ("port", port)):
        traj = [(t, run["traj"][t]) for t, _ in tail if t in run["traj"]]
        ates[tag] = ate_rmse(traj, tail)["ate_rmse"]
        assert ates[tag] < 0.05, (tag, ates)
    bound = max(0.02, ates["reference"])
    print(f"ATE over the second half: reference "
          f"{ates['reference'] * 100:.3f} cm, port {ates['port'] * 100:.3f}"
          f" cm")
    for i, (a, b) in enumerate(zip(ref["poses"], port["poses"])):
        err = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert err < bound, (i, err, bound)
    assert set(port["traj"]) == set(ref["traj"])
    for t, a in ref["traj"].items():
        assert np.linalg.norm(a[:3, 3] - port["traj"][t][:3, 3]) < bound, t
    return ref, port, slam


def test_icp_inertial_edgeicp(scene, references):
    slam = _check(scene, {}, lambda: references("edgeicp"))[2]
    assert slam.n_icp_accepted >= 1


def test_icp_carried_inertial(references, tmp_path_factory):
    blank = CARRIED_BLANK
    ref, port, slam = _check(
        _shared(tmp_path_factory, "carried_scene", _carried_scene), {},
        lambda: references("carried"))
    print(f"states {port['states']}; carried {slam.n_icp_carried}")
    assert port["states"] == ref["states"]
    assert all(ref["states"][i] == "OK" for i in blank)
    assert slam.n_icp_carried >= len(blank)
    kf_in = {tag: sorted({run["kf_times"][i] for i in blank}
                         - {run["kf_times"][blank[0] - 1]})
             for tag, run in (("reference", ref), ("port", port))}
    print(f"KFs inside the window at {kf_in}")
    assert kf_in["reference"] and kf_in["port"] == kf_in["reference"]
    np.testing.assert_allclose(port["v"], ref["v"], atol=0.05, rtol=0)


def _spy_staged_kfs(cls, staged, fused=None):
    """Wrap cls.<staged> (the staged KF step; with `fused`, a dispatcher
    that may hand the KF to cls.<fused>) to log the timestamps of the
    staged KF steps that start after the IMU initialized."""
    log, inner = [], [0]
    f_staged = getattr(cls, staged)

    def spy(self, frame, timestamp, *a, **k):
        before, init = inner[0], self.imu.initialized
        out = f_staged(self, frame, timestamp, *a, **k)
        if init and inner[0] == before:
            log.append(round(timestamp, 4))
        return out
    if fused is not None:
        f_fused = getattr(cls, fused)

        def count(self, *a, **k):
            inner[0] += 1
            return f_fused(self, *a, **k)
        setattr(cls, fused, count)
    setattr(cls, staged, spy)
    return log


def test_lidar_inertial(scene, references, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(SlamSystem, "_insert_keyframe_staged",
                  SlamSystem._insert_keyframe_staged)
        port_staged = _spy_staged_kfs(SlamSystem, "_insert_keyframe_staged")
        ref, port, slam = _check(scene, dict(use_lidar=True),
                                 lambda: references("lidar"), edges=False)
    staged = {"reference": ref["staged"], "port": port_staged}
    print(f"staged KF steps after the IMU initialized: {staged}")
    assert port["states"] == ref["states"]
    assert staged["reference"] and staged["port"] == staged["reference"]
    n_ref, n_port = ref["n_global"], len(slam.global_map.points())
    print(f"global map {n_ref} and {n_port} points")
    assert n_ref > 500 and n_port > 500
    counts = dict(slam.plane_factor_counts)
    second = next(i for i in range(len(port["kf_times"]))
                  if len(set(port["kf_times"][:i + 1])) >= 2)
    after = [counts[round(t, 4)] for t, _ in scene[2][second + 1:]]
    assert after and min(after) > 0, after


@pytest.mark.slow
def test_icp_of_inertial_edgeicp(scene):
    kw = dict(use_of=True, n_of_slots=256)
    slam = _check(scene, kw, lambda: _jax_run(scene, kw)[0])[2]
    assert sum(slam.of_appended) > 5
