"""The port's monocular slice end to end against a JAX SlamSystem, on the
CPU, at the JAX e2e tests' sizes:

* track_monocular on tests/test_e2e_mono.py's scenario (320x240, fx 200,
  400 features, 4 levels, 40 frames at 10 fps, min_inliers_ok 12), both
  systems on the same frames, the initializer's RANSAC fed the same Gumbel
  noise (the reference draws it from PRNGKey(1234), split per attempt and
  into the F and H keys; the test hands the port's _sample_minimal_sets
  the same draws). Gates: the same init frame and state on every frame,
  the KF count +-1; with each trajectory aligned to ground truth in 7 DoF,
  every pose within max(2 cm, 2 x the reference's ATE) of the reference's
  and their median within max(2 cm, the reference's ATE); the port's ATE
  over the last 3/4 < 6 cm (tests/test_e2e_mono.py:45); the
  best-two Hamming search (one kernel launch on the card) called once per
  init attempt and three times per KF after the init's two.
* track_monocular_inertial on tests/test_e2e_mono_inertial.py's scenario
  (the same rig, scale 1.2, 200 Hz IMU, ImuConfig(init_min_kfs=5,
  init_min_time=0.8), 42 frames), the port alone: OK, the IMU initialized
  (scale_free), the 7-DoF ATE over the last 2/5 < 8 cm
  (tests/test_e2e_mono_inertial.py:55), and the trajectory rebased at the
  init: a frame recorded before it moves by the init's (R_gw, s). In the
  slow tier, beside the JAX SlamSystem through the IMU initialization:
  the same states, the same mono and IMU init frames, the init's scale
  within 25%, poses held as above. Past the IMU init the two runs are not
  compared frame by frame: its scale solve turns a 0.8% difference of the
  visual map into an 18% difference of scale (2.82 against 2.39 with the
  reference's draws), a KF decision at the 0.8 x reference-inliers edge
  then goes the other way (frame 23: 84 against 76 inliers), and the port
  loses the track on frame 35 where the reference holds. With the init
  keys 0-8 instead of 1234 both packages hold every frame, at 7-DoF ATEs
  of 1.1-7.6 cm (the port) and 1.2-9.0 cm (the reference, over its own
  8 cm gate on key 7).

The pose bound is twice the reference's ATE, not once: the init pair is 2
cm apart at the map's scale (median depth 1), so its farthest points
(depth ~12) are ill-conditioned; the reference triangulates them in
float32, the port in float64, and they land up to 0.7 apart. A few
matches differ from there on, and two valid runs part by about their own
ATE (8.3 cm at most, 4.5 cm median, against the reference's 5.8 cm ATE;
the port alone with float32 instead of float64 triangulation moves by 2.4
cm)."""
import jax
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
from geoflowslam_tpu_torch.eval.ate import ate_rmse, associate, umeyama_align
from geoflowslam_tpu_torch.ops import matching as TMA
from geoflowslam_tpu_torch.ops import ransac as TR
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
N_MONO, N_MI = 40, 42
SAMPLE_SETS = TR._sample_minimal_sets


def _twc(rot_cw, t_cw):
    r = np.asarray(rot_cw, np.float64)
    twc = np.eye(4)
    twc[:3, :3] = r.T
    twc[:3, 3] = -r.T @ np.asarray(t_cw, np.float64)
    return twc


def _frames(n, scale=1.0, imu=False):
    cam = JS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=FPS, scale=scale)
    out = []
    for i in range(n):
        t = i / FPS
        g, _, (rot_cw, t_cw) = seq.frame(t)
        out.append(dict(
            t=t, gray=np.array(g), gt=_twc(rot_cw, t_cw),
            imu=(tuple(np.array(x) for x in seq.imu_between(
                (i - 1) / FPS, t, 32)) if imu and i else None)))
    return out


@pytest.fixture(scope="module")
def mono_frames():
    return _frames(N_MONO)


@pytest.fixture(scope="module")
def mi_frames():
    return _frames(N_MI, scale=1.2, imu=True)


def _configs(imu: bool):
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=0.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=0.0, k_max=24,
              m_max=4096, sensor="mono", min_inliers_ok=12)
    ic = dict(init_min_kfs=5, init_min_time=0.8)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc),
                 imu=JImu(**ic) if imu else None, **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(**ic) if imu else None, **sc))


class JaxInitDraws:
    """The port's _sample_minimal_sets fed the reference initializer's
    Gumbel noise: per attempt PRNGKey(1234) split once more, its key split
    into the F and H keys, gumbel(key, (n_hyp, N)) each."""

    def __init__(self):
        self.key = jax.random.PRNGKey(1234)
        self.keys = []

    def __call__(self, gen, valid, n_hyp, set_size, noise=None):
        if not self.keys:
            self.key, k = jax.random.split(self.key)
            self.keys = list(jax.random.split(k))
            assert set_size == 8           # the F sets come first
        g = np.array(jax.random.gumbel(self.keys.pop(0),
                                       (n_hyp, valid.shape[0])))
        return SAMPLE_SETS(gen, valid, n_hyp, set_size,
                           noise=torch.from_numpy(g).to(valid.device))


def _run(slam, frames, inertial=False):
    states, init = [], None
    for i, f in enumerate(frames):
        if inertial and i > 0:
            twc = slam.track_monocular_inertial(f["gray"], *f["imu"], f["t"])
        else:
            twc = slam.track_monocular(f["gray"], f["t"])
        assert np.all(np.isfinite(np.asarray(twc)))
        states.append(slam.state.name)
        if init is None and slam.state.name == "OK":
            init = i
    return dict(states=states, init=init, traj=slam.trajectory,
                stats=slam.map_stats())


def _aligned(traj, gt):
    """{t: position} of traj aligned to ground truth in 7 DoF."""
    pairs = associate(np.array([e[0] for e in traj]),
                      np.array([g[0] for g in gt]))
    pe = np.stack([traj[i][1][:3, 3] for i, _ in pairs])
    pg = np.stack([gt[j][1][:3, 3] for _, j in pairs])
    s, rot, t = umeyama_align(pe, pg, with_scale=True)
    return {traj[i][0]: s * rot @ p + t for (i, _), p in zip(pairs, pe)}


def _compare(port, ref, frames, tail):
    """The states, init frame and KF count; the aligned poses within
    max(2 cm, 2 x the reference's ATE), their median within the reference's
    ATE (see the module docstring); returns the port's ATE over `tail`."""
    assert port["init"] == ref["init"], (port["init"], ref["init"])
    assert port["states"] == ref["states"]
    assert abs(port["stats"]["n_kfs"] - ref["stats"]["n_kfs"]) <= 1
    gt = [(f["t"], f["gt"]) for f in frames]
    ate_ref = ate_rmse(ref["traj"], gt, with_scale=True)["ate_rmse"]
    a_port, a_ref = _aligned(port["traj"], gt), _aligned(ref["traj"], gt)
    assert sorted(a_port) == sorted(a_ref)
    errs = [np.linalg.norm(a_port[t] - p) for t, p in a_ref.items()]
    assert max(errs) < max(0.02, 2 * ate_ref), (max(errs), ate_ref)
    assert np.median(errs) < max(0.02, ate_ref), (np.median(errs), ate_ref)
    n = len(port["traj"]) * tail[0] // tail[1]
    return ate_rmse(port["traj"][-n:], gt[-n:], with_scale=True)["ate_rmse"]


def test_mono_slice_against_reference(mono_frames, monkeypatch):
    jcfg, tcfg = _configs(imu=False)
    ref = _run(JSlam(jcfg), mono_frames)
    monkeypatch.setattr(TR, "_sample_minimal_sets", JaxInitDraws())
    searches = []
    best2 = TMA.hamming_best2_many

    def counted(s):
        searches.append(len(s))
        return best2(s)
    monkeypatch.setattr(TMA, "hamming_best2_many", counted)
    slam = SlamSystem(tcfg, device="cpu")
    port = _run(slam, mono_frames)
    assert port["stats"]["state"] == "OK" and port["stats"]["n_kfs"] >= 2
    ate = _compare(port, ref, mono_frames, (3, 4))
    assert ate < 0.06, ate
    # one search call (both directions, one launch on the card) per init
    # attempt, three per KF after the init's two
    n_kf_after = slam._gen_counter - 2
    assert slam.n_init_attempts >= 1 and n_kf_after >= 1
    assert len(searches) == slam.n_init_attempts + 3 * n_kf_after
    assert all(n == 2 for n in searches)
    assert len(slam.n_triangulated) == n_kf_after
    assert slam.mono_init_info["time"] == mono_frames[port["init"]]["t"]


def _transform(twc, rot, s):
    m = twc.copy()
    m[:3, :3] = rot @ m[:3, :3]
    m[:3, 3] = s * (rot @ m[:3, 3])
    return m


def test_mono_inertial_gates_and_init_rebase(mi_frames):
    _, tcfg = _configs(imu=True)
    slam = SlamSystem(tcfg, device="cpu")
    seen = {}
    consume = slam._consume_imu_transform

    def spy():
        tr = slam.imu.last_transform
        consume()
        if tr is not None and "init" not in seen:
            seen["init"] = (tr, dict(slam.trajectory))
    slam._consume_imu_transform = spy
    before = {}
    for i, f in enumerate(mi_frames):
        if i == 0:
            slam.track_monocular(f["gray"], f["t"])
        else:
            slam.track_monocular_inertial(f["gray"], *f["imu"], f["t"])
        if "init" not in seen:
            before = dict(slam.trajectory)
    stats = slam.map_stats()
    assert stats["state"] == "OK", stats
    assert slam.imu.initialized
    gt = [(f["t"], f["gt"]) for f in mi_frames]
    tail = len(slam.trajectory) * 2 // 5
    ate = ate_rmse(slam.trajectory[-tail:], gt[-tail:], with_scale=True)
    assert ate["ate_rmse"] < 0.08, (ate, stats)
    # the frames recorded before the init, read back right after its
    # transform was folded in, moved by (R_gw, s)
    (rot, s), after = seen["init"]
    rot = np.asarray(rot, np.float64)
    assert abs(s - 1.0) > 1e-3 and len(before) >= 5
    for t, twc in before.items():
        want = _transform(twc, rot, s)
        assert np.abs(after[t] - want).max() < 1e-4 * max(1.0, s), t


@pytest.mark.slow
def test_mono_inertial_slice_against_reference(mi_frames, monkeypatch):
    """Beside the reference through the IMU initialization: the same mono
    init frame and IMU init frame, the same states up to it, the init's
    scale within 25% of the reference's, the aligned poses up to it within
    max(2 cm, 2 x the reference's ATE over them), the port's IMU scale-free
    initialized (see the module docstring for what comes after)."""
    jcfg, tcfg = _configs(imu=True)
    ref_sys = JSlam(jcfg)
    scales = {}
    transform = ref_sys._transform_trajectory

    def ref_spy(rot, s):
        scales.setdefault("ref", float(s))
        return transform(rot, s)
    ref_sys._transform_trajectory = ref_spy
    ref = _run_until_imu_init(ref_sys, mi_frames)
    monkeypatch.setattr(TR, "_sample_minimal_sets", JaxInitDraws())
    slam = SlamSystem(tcfg, device="cpu")
    consume = slam._consume_imu_transform

    def port_spy():
        if slam.imu.last_transform is not None:
            scales.setdefault("port", float(slam.imu.last_transform[1]))
        consume()
    slam._consume_imu_transform = port_spy
    port = _run_until_imu_init(slam, mi_frames)
    assert port["init"] == ref["init"]
    assert port["imu_init"] == ref["imu_init"] is not None
    assert port["states"] == ref["states"]
    assert abs(scales["port"] / scales["ref"] - 1.0) < 0.25, scales
    frames = mi_frames[:port["imu_init"] + 1]
    gt = [(f["t"], f["gt"]) for f in frames]
    ate_ref = ate_rmse(ref["traj"], gt, with_scale=True)["ate_rmse"]
    a_port, a_ref = _aligned(port["traj"], gt), _aligned(ref["traj"], gt)
    for t, p in a_ref.items():
        assert np.linalg.norm(a_port[t] - p) < max(0.02, 2 * ate_ref)


def _run_until_imu_init(slam, frames):
    """_run over the mono-inertial frames, ending on the frame whose KF
    initialized the IMU."""
    states, init, imu_init = [], None, None
    for i, f in enumerate(frames):
        if i == 0:
            slam.track_monocular(f["gray"], f["t"])
        else:
            slam.track_monocular_inertial(f["gray"], *f["imu"], f["t"])
        states.append(slam.state.name)
        if init is None and slam.state.name == "OK":
            init = i
        if slam.imu.initialized:
            imu_init = i
            break
    return dict(states=states, init=init, imu_init=imu_init,
                traj=slam.trajectory)
