"""The port's stereo slice and its staged IMU step, frame by frame against a
JAX SlamSystem on the same frames, at the JAX e2e tests' small sizes:

* track_stereo over 30 frames of tests/test_e2e_stereo.py's rig (320x240,
  fx 200, a rectified pair 0.1 m apart, 4 levels, 10 fps);
* track_stereo_inertial over 35 frames of the same rig with 200 Hz IMU
  samples and ImuConfig(init_min_kfs=4, init_min_time=0.5)
  (tests/test_e2e_stereo.py:80-121), the first frame through track_stereo;
* track_stereo_fisheye over 20 frames of tests/test_stereo_fisheye.py's
  dual-KB8 rig (fx 140, kf_min_interval 1, kf_max_interval 4);
* track_rgbd_inertial with record_reproj_err (every frame through the
  staged step) on tests/test_torch_slice_inertial.py's scenario through
  the IMU initialization, then 8 blank frames (gray flat at 100, depth
  kept): the staged step's IMU prediction, its KF while lost and the
  recovery;
* the staged step's time guards with the IMU (a 1.7 s gap before the
  initialization, then an older timestamp): the map reset and the frame
  starting the new map in both packages;
* in the slow tier: track_stereo_fisheye_inertial over 25 frames
  (ImuConfig(init_min_kfs=4, init_min_time=0.8)), and RGB-D-inertial
  without a vocabulary through the same blank frames (the fused step while
  OK, the staged step on every frame that starts RECENTLY_LOST).

Every system runs at one size (400 features, k_max 24, m_max 4096, 1024
cloud points), so that the reference's compiled programs serve all of
them: the reference's runs of the first four tier-1 cases are made one
after another in one process, once per session (the `references`
fixture, shared by the xdist workers through tests/test_torch_shared.py),
and each case runs the port against its run. Gates: the same state on every frame, the same KF count +-1, the IMU
initialized on the same frame; every returned pose within max(2 cm, the
reference's own ATE) of the reference's; the reference's own accuracy
gates on the port (ATE < 6 cm; fisheye < 5 cm, with_scale=False).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import StereoFisheyeConfig as JSF
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from test_torch_shared import shared_result

torch.set_num_threads(2)

W, H, FPS = 320, 240, 10.0
KB8_L = (0.0035, 0.0007, -0.002, 0.0002)
KB8_R = (0.0034, 0.0018, -0.0027, 0.0003)
BLANK = range(20, 28)


def _twc(rot_cw, t_cw):
    r = np.asarray(rot_cw, np.float64)
    twc = np.eye(4)
    twc[:3, :3] = r.T
    twc[:3, 3] = -r.T @ np.asarray(t_cw, np.float64)
    return twc


def _imu(seq, i):
    return tuple(np.array(x) for x in seq.imu_between((i - 1) / FPS, i / FPS,
                                                      32))


@pytest.fixture(scope="module")
def rectified(tmp_path_factory):
    return shared_result(tmp_path_factory,
                         "test_torch_slice_stereo.rectified", _rectified)


def _rectified():
    """35 rectified pairs (the right camera at t_cw + (-0.1, 0, 0),
    tests/test_e2e_stereo.py:20-27), their IMU samples and ground truth."""
    cam = JS.Camera(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W,
                    height=H)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=FPS)
    out = []
    for i in range(35):
        rot_cw, t_cw = seq.pose_cw(i / FPS)
        gl, _ = seq._render(rot_cw, t_cw)
        gr, _ = seq._render(rot_cw, t_cw + jnp.array([-0.1, 0.0, 0.0]))
        out.append(dict(t=i / FPS, images=(np.array(gl), np.array(gr)),
                        imu=_imu(seq, i) if i else None,
                        gt=_twc(rot_cw, t_cw)))
    return out


def _stereo_configs(imu: bool):
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096)
    ic = dict(init_min_kfs=4, init_min_time=0.5)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc),
                 imu=JImu(**ic) if imu else None, **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(**ic) if imu else None, **sc))


def _fisheye_configs(imu: bool):
    fx = 140.0
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=fx * 0.1,
              camera_model="kb8", dist_params=KB8_L)
    r_lr, t_lr = _rig()
    sf = dict(params_r=(fx + 0.5, fx + 0.3, W / 2 - 1.0, H / 2 + 0.5,
                        *KB8_R),
              r_lr=tuple(r_lr.reshape(-1).tolist()),
              t_lr=tuple(t_lr.tolist()), lapping_l=(0.0, float(W)),
              lapping_r=(0.0, float(W)))
    sc = dict(fx=fx, fy=fx, cx=W / 2, cy=H / 2, bf=fx * 0.1, k_max=24,
              m_max=4096, sensor="stereo", kf_min_interval=1,
              kf_max_interval=4)
    ic = dict(init_min_kfs=4, init_min_time=0.8)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc),
                 stereo_fisheye=JSF(**sf), imu=JImu(**ic) if imu else None,
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           stereo_fisheye=C.StereoFisheyeConfig(**sf),
                           imu=C.ImuConfig(**ic) if imu else None, **sc))


def _rig():
    """Right -> left extrinsics of tests/test_stereo_fisheye.py's e2e rig
    (baseline 0.1 m, a small rotation)."""
    r_lr = np.asarray(JL.so3_exp(jnp.array([0.002, -0.001, 0.0008])))
    return r_lr, np.array([0.1, 0.002, 0.001], np.float32)


@pytest.fixture(scope="module")
def fisheye(tmp_path_factory):
    return shared_result(tmp_path_factory, "test_torch_slice_stereo.fisheye",
                         _fisheye)


def _fisheye():
    """25 frames of the dual-KB8 rig, both images ray-cast through KB8."""
    fx = 140.0
    caml = JS.Camera(fx=fx, fy=fx, cx=W / 2, cy=H / 2, width=W, height=H,
                     kb8=KB8_L)
    camr = JS.Camera(fx=fx + 0.5, fy=fx + 0.3, cx=W / 2 - 1.0,
                     cy=H / 2 + 0.5, width=W, height=H, kb8=KB8_R)
    r_lr, t_lr = _rig()
    rot_rl = r_lr.T
    t_rl = -rot_rl @ t_lr
    seq = JS.SyntheticSequence(JS.SyntheticWorld(caml), fps=FPS)
    render_r = jax.jit(JS.SyntheticWorld(camr).render)
    out = []
    for i in range(25):
        gl, _, (rot_cw, t_cw) = seq.frame(i / FPS)
        gr, _ = render_r(jnp.asarray(rot_rl) @ rot_cw,
                         jnp.asarray(rot_rl) @ t_cw + jnp.asarray(t_rl))
        out.append(dict(t=i / FPS, images=(np.array(gl), np.array(gr)),
                        imu=_imu(seq, i) if i else None,
                        gt=_twc(rot_cw, t_cw)))
    return out


@pytest.fixture(scope="module")
def rgbd(tmp_path_factory):
    return shared_result(tmp_path_factory, "test_torch_slice_stereo.rgbd",
                         _rgbd)


def _rgbd():
    """tests/test_torch_slice_inertial.py's scenario: 36 frames, 8 of them
    blank after the IMU initializes."""
    cam = JS.Camera(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W,
                    height=H)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=FPS)
    out = []
    for i in range(36):
        g, d, (rot_cw, t_cw) = seq.frame(i / FPS)
        g = np.full_like(np.array(g), 100.0) if i in BLANK else np.array(g)
        out.append(dict(t=i / FPS, images=(g, np.array(d)),
                        imu=_imu(seq, i) if i else None,
                        gt=_twc(rot_cw, t_cw)))
    return out


def _run(slam, frames, plain: str, inertial: str = None):
    """Drive `slam` over `frames`: the first frame (and every frame without
    `inertial`) through the entry point `plain`, the others through
    `inertial` with their IMU samples."""
    poses, states, init = [], [], None
    for i, f in enumerate(frames):
        if inertial is not None and i > 0:
            twc = getattr(slam, inertial)(*f["images"], *f["imu"], f["t"])
        else:
            twc = getattr(slam, plain)(*f["images"], f["t"])
        assert np.all(np.isfinite(np.asarray(twc)))
        poses.append(np.asarray(twc))
        states.append(slam.state.name)
        if init is None and slam.imu is not None and slam.imu.initialized:
            init = i
    return dict(poses=poses, states=states, init=init,
                traj=slam.trajectory, stats=slam.map_stats())


def _compare(port, ref, frames, ate_gate, with_scale=True, tail=False):
    """The slice gates (module docstring); returns the two ATEs."""
    gt = [(f["t"], f["gt"]) for f in frames]
    if tail:
        half = len(port["traj"]) // 2
        ates = [ate_rmse(r["traj"][-half:], gt[-half:],
                         with_scale=with_scale)["ate_rmse"]
                for r in (port, ref)]
    else:
        ates = [ate_rmse(r["traj"], gt, with_scale=with_scale)["ate_rmse"]
                for r in (port, ref)]
    assert port["states"] == ref["states"]
    assert port["init"] == ref["init"]
    assert port["stats"]["state"] == "OK"
    assert abs(port["stats"]["n_kfs"] - ref["stats"]["n_kfs"]) <= 1, (
        port["stats"], ref["stats"])
    bound = max(0.02, ates[1])
    for i, (a, b) in enumerate(zip(port["poses"], ref["poses"])):
        err = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert err < bound, (i, err, bound)
    assert ates[0] < ate_gate, ates
    return ates


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """A getter of the reference's runs of test_track_stereo,
    test_track_stereo_inertial, test_track_stereo_fisheye and
    test_rgbd_inertial_staged, made in one process one after another, once
    per session for every xdist worker. A case calls it once its port run
    is done (a worker that waits for another to make them has done its
    own part first)."""
    def compute():
        get = lambda name, fn: shared_result(                    # noqa
            tmp_path_factory, f"test_torch_slice_stereo.{name}", fn)
        rect, fish = get("rectified", _rectified), get("fisheye", _fisheye)
        return dict(
            stereo=_run(JSlam(_stereo_configs(imu=False)[0]), rect[:30],
                        "track_stereo"),
            stereo_inertial=_run(JSlam(_stereo_configs(imu=True)[0]), rect,
                                 "track_stereo", "track_stereo_inertial"),
            fisheye=_run(JSlam(_fisheye_configs(imu=False)[0]), fish[:20],
                         "track_stereo_fisheye"),
            rgbd_staged=_run(
                JSlam(_rgbd_configs(record_reproj_err=True)[0]),
                get("rgbd", _rgbd), "track_rgbd", "track_rgbd_inertial"))
    return lambda: shared_result(tmp_path_factory,
                                 "test_torch_slice_stereo.references",
                                 compute)


def test_track_stereo(rectified, references):
    _, tcfg = _stereo_configs(imu=False)
    frames = rectified[:30]
    port = _run(SlamSystem(tcfg, "cpu"), frames, "track_stereo")
    _compare(port, references()["stereo"], frames, 0.06)
    assert port["stats"]["n_kfs"] >= 2


def test_track_stereo_inertial(rectified, references):
    _, tcfg = _stereo_configs(imu=True)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, rectified, "track_stereo", "track_stereo_inertial")
    ref = references()["stereo_inertial"]
    assert ref["init"] is not None
    _compare(port, ref, rectified, 0.06, tail=True)
    assert slam.imu_modes.get("kf", 0) + slam.imu_modes.get("prior", 0) > 0
    assert slam.n_vi_accepted > 0


def test_staged_time_guards(rectified):
    """The staged step's time guards with an IMU (the reference's _track):
    a gap over max_frame_gap before the IMU initializes resets the active
    map and the frame starts the new one, as does an older timestamp; both
    packages end in the same state, map count and pose."""
    jcfg, tcfg = _stereo_configs(imu=True)
    out = []
    for slam in (SlamSystem(tcfg, "cpu"), JSlam(jcfg)):
        f = rectified
        slam.track_stereo(*f[0]["images"], f[0]["t"])
        for i in (1, 2, 3):
            slam.track_stereo_inertial(*f[i]["images"], *f[i]["imu"],
                                       f[i]["t"])
        runs = []
        for i, t in ((4, 2.0), (5, 1.5)):     # a 1.7 s gap, then older
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                twc = slam.track_stereo_inertial(*f[i]["images"],
                                                 *f[i]["imu"], t)
            runs.append((slam.state.name, slam.map_stats()["n_maps"],
                         np.asarray(twc), len(caught)))
        out.append(runs)
    # the port warns through `warnings` (the reference prints to stderr)
    assert all(n == 1 for *_, n in out[0])
    for (sp, mp, tp, _), (sr, mr, tr, _) in zip(*out):
        assert (sp, mp) == (sr, mr) == ("OK", mp) and mp >= 2
        np.testing.assert_allclose(tp, tr, atol=1e-6)


def test_track_stereo_fisheye(fisheye, references):
    _, tcfg = _fisheye_configs(imu=False)
    frames = fisheye[:20]
    port = _run(SlamSystem(tcfg, "cpu"), frames, "track_stereo_fisheye")
    _compare(port, references()["fisheye"], frames, 0.05, with_scale=False)


def _rgbd_configs(**kw):
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096, **kw)
    ic = dict(init_min_kfs=4, init_min_time=0.5)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), imu=JImu(**ic),
                 pkt_max_pending=0, **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(**ic), **sc))


def _rgbd_inertial(frames, get_ref=None, **kw):
    """The port over `frames` against the reference's run that get_ref()
    returns (made here when get_ref is None)."""
    jcfg, tcfg = _rgbd_configs(**kw)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, frames, "track_rgbd", "track_rgbd_inertial")
    ref = (_run(JSlam(jcfg), frames, "track_rgbd", "track_rgbd_inertial")
           if get_ref is None else get_ref())
    assert ref["init"] is not None and ref["init"] < BLANK[0]
    assert all(ref["states"][i] == "RECENTLY_LOST" for i in BLANK)
    _compare(port, ref, frames, 0.06)
    return slam


def test_rgbd_inertial_staged(rgbd, references):
    """record_reproj_err: every frame takes the staged step, the blank ones
    dead-reckon from the IMU prediction and insert a KF while lost."""
    slam = _rgbd_inertial(rgbd, lambda: references()["rgbd_staged"],
                          record_reproj_err=True)
    assert len(slam.f2m_reproj) == len(rgbd) - 1
    assert slam.n_vi_accepted > 0


@pytest.mark.slow
def test_rgbd_inertial_without_vocabulary(rgbd):
    """No vocabulary: the fused step while OK, the staged step on every
    frame that starts RECENTLY_LOST."""
    slam = _rgbd_inertial(rgbd)
    assert slam.n_vi_accepted > 0


@pytest.mark.slow
def test_track_stereo_fisheye_inertial(fisheye):
    jcfg, tcfg = _fisheye_configs(imu=True)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, fisheye, "track_stereo_fisheye",
                "track_stereo_fisheye_inertial")
    ref = _run(JSlam(jcfg), fisheye, "track_stereo_fisheye",
               "track_stereo_fisheye_inertial")
    assert ref["init"] is not None
    _compare(port, ref, fisheye, 0.06, with_scale=False)
