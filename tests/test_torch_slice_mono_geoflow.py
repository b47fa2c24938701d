"""The port's monocular sensor with GeoFlow's streams (optical flow,
odometry, ICP and lidar) against a JAX SlamSystem, on the CPU, on
tests/test_torch_slice_mono.py's scenario (320x240, fx 200, 400 features,
4 levels, 40 frames at 10 fps, min_inliers_ok 12), the reference's RANSAC
draws handed over: the initializer's (PRNGKey(1234), split per attempt)
and, from the same key chain, each frame's optical-flow F-RANSAC noise
(split once per frame after the init, then into the 3D and 2D streams'
keys), as the reference's staged step draws them.

* use_of (64 OF slots): the same init frame and states on every frame, the
  same KF count, OF points appended, the LK pyramid (the fused K3 kernel
  on the card) run once a frame after the init. Each trajectory is aligned
  to ground truth in 7 DoF; the RMS of the per-frame differences within 2
  x the reference's ATE, their median within max(2 cm, its ATE) and the
  largest within MAX_DIFF. The largest is not held to 2 x ATE as in the
  plain mono test: the two runs part by up to 15.6 cm on one frame
  against a 5.7 cm reference ATE (printed by _hold). Both maps start from
  one init; the scene amplifies rounding-level changes that far. The
  port against itself with its monocular triangulation in float32 (the
  reference's precision) in place of float64 parts by up to 9.6 cm here
  and 15.6 cm under odometry, and against the reference by 12.9 and 15.0
  cm: the precision is not the cause, the amplification is.
* use_odom, the trajectory's world velocity queued before every frame:
  the same gates, and every tracked frame reads and empties the queue in
  both packages (the monocular sensor runs the staged step on every
  frame). The velocity is metric and the map's scale is free (median depth
  1 at the init), so every prediction lands ~3x too far; both packages do
  this (ROADMAP's questionable behaviours), and single frames part by up
  to 13.8 cm against ATEs of 4.2 (reference) and 3.5 cm (port), within
  the 15.6 cm that the float32 triangulation alone moves the port.
* use_icp with use_lidar: a frame without depth has no cloud, so no
  registration and no plane factor; the trajectory equals the plain
  monocular run's in each package (24 frames).
* slow tier: track_monocular_inertial with use_of beside the reference
  through the IMU initialization (tests/test_e2e_mono_inertial.py's
  scenario): the same mono and IMU init frames and states up to it.
* slow tier: chip_smoke.py's mono_geoflow configuration (mono_tum's
  intrinsics, 1000 features, 8 levels, 256 OF slots, odometry) at 320x240
  and at its 640x480 over 120 frames at 30 fps, each package with its own
  draws: the same init frame and states, KF counts within 1; at 320x240
  both 7-DoF ATEs over the last 3/4 under test_e2e_mono.py's 6 cm; at
  640x480, where the OF slots lift it past 6 cm in both packages, the
  reference's ATE equal to REF_ATE_640 and the port's under the card
  phase's gate, that reading plus 5 mm (chip_smoke.MONO_GEOFLOW_ATE).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.math import triangulate as TRI
from geoflowslam_tpu_torch.ops import klt as TK
from geoflowslam_tpu_torch.ops import ransac as TR
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.pipeline import mono_init as TMI
from geoflowslam_tpu_torch.pipeline import of_tracking as TOF
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from test_torch_slice_mono import (N_MI, N_MONO, SAMPLE_SETS, _aligned,
                                   _configs, _frames, _run_until_imu_init)

torch.set_num_threads(2)

N_OF = 64
# m: the largest per-frame difference _hold admits. The port moves by up
# to 15.6 cm on one frame against its own run with float32 triangulation
# (use_odom); about 30% on top.
MAX_DIFF = 0.20


class JaxDraws:
    """The reference's draws for the port: the initializer's minimal sets
    (as test_torch_slice_mono.JaxInitDraws) and each OF stage's Gumbel
    noise, all from one key chain PRNGKey(1234). Draws that already carry
    their noise pass through."""

    def __init__(self):
        self.key = jax.random.PRNGKey(1234)
        self.keys = []
        self.n_of = 0

    def sets(self, gen, valid, n_hyp, set_size, noise=None):
        if noise is None:
            if not self.keys:
                self.key, k = jax.random.split(self.key)
                self.keys = list(jax.random.split(k))
            noise = torch.from_numpy(np.array(jax.random.gumbel(
                self.keys.pop(0), (n_hyp, valid.shape[0]))))
        return SAMPLE_SETS(gen, valid, n_hyp, set_size, noise=noise)

    def of_stage(self, fn):
        def wrapped(ms, last_frame, cur_frame, *a, **kw):
            self.key, kof = jax.random.split(self.key)
            n = cur_frame.feat.capacity
            kw["gumbel"] = tuple(torch.from_numpy(np.array(
                jax.random.gumbel(k, (64, n))))
                for k in jax.random.split(kof))
            self.n_of += 1
            return fn(ms, last_frame, cur_frame, *a, **kw)
        return wrapped

    def install(self, monkeypatch):
        monkeypatch.setattr(TR, "_sample_minimal_sets", self.sets)
        monkeypatch.setattr(TOF, "of_dual_stream",
                            self.of_stage(TOF.of_dual_stream))


def _velocity(t):
    return np.array(JS.smooth_trajectory(np.float32(t))[2])


def _run(slam, frames, odom=False):
    states, init, reads = [], None, 0
    for i, f in enumerate(frames):
        if odom:
            slam.set_odom(_velocity(f["t"]), odom_frame=False)
        twc = slam.track_monocular(f["gray"], f["t"])
        assert np.all(np.isfinite(np.asarray(twc)))
        states.append(slam.state.name)
        if init is None and slam.state.name == "OK":
            init = i
        if odom and not slam._odom_queue:
            reads += 1
    return dict(states=states, init=init, traj=slam.trajectory,
                stats=slam.map_stats(), reads=reads)


def _with(cfgs, n_of=0, **kw):
    return tuple(dataclasses.replace(
        c, frame=dataclasses.replace(c.frame, n_of_slots=n_of), **kw)
        for c in cfgs)


def _hold(port, ref, frames):
    """The same init frame, states and KF count; the aligned trajectories'
    RMS difference within 2 x the reference's ATE, their median within
    max(2 cm, its ATE), the largest within MAX_DIFF; prints the ATEs and
    the differences."""
    assert port["init"] == ref["init"] is not None
    assert port["states"] == ref["states"]
    assert port["stats"]["n_kfs"] == ref["stats"]["n_kfs"]
    assert port["stats"]["state"] == "OK"
    gt = [(f["t"], f["gt"]) for f in frames]
    ate_ref = ate_rmse(ref["traj"], gt, with_scale=True)["ate_rmse"]
    ate_port = ate_rmse(port["traj"], gt, with_scale=True)["ate_rmse"]
    a_port, a_ref = _aligned(port["traj"], gt), _aligned(ref["traj"], gt)
    assert sorted(a_port) == sorted(a_ref)
    errs = np.array([np.linalg.norm(a_port[t] - p) for t, p in a_ref.items()])
    print(f"ATE reference {ate_ref:.4f} m, port {ate_port:.4f} m; "
          f"per-frame difference RMS {np.sqrt(np.mean(errs ** 2)):.4f}, "
          f"median {np.median(errs):.4f}, max {errs.max():.4f} m")
    assert np.sqrt(np.mean(errs ** 2)) < 2 * ate_ref, (errs, ate_ref)
    assert np.median(errs) < max(0.02, ate_ref), (errs, ate_ref)
    assert errs.max() < MAX_DIFF, (errs, ate_ref)


@pytest.fixture(scope="module")
def mono_frames():
    return _frames(N_MONO)


def test_mono_of_against_reference(mono_frames, monkeypatch):
    jcfg, tcfg = _with(_configs(imu=False), n_of=N_OF, use_of=True)
    ref = _run(JSlam(jcfg), mono_frames)
    draws = JaxDraws()
    draws.install(monkeypatch)
    lk_calls = []
    lk = TK.fb_klt_track_streams

    def counted(*a, **kw):
        lk_calls.append(1)
        return lk(*a, **kw)
    monkeypatch.setattr(TK, "fb_klt_track_streams", counted)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, mono_frames)
    _hold(port, ref, mono_frames)
    # the OF stage on every frame after the init, one LK pyramid call each
    after = len(mono_frames) - port["init"] - 1
    assert draws.n_of == len(lk_calls) == after
    n3d, n2d = slam.of_appended
    assert n3d > 5 and n2d > 5, slam.of_appended


def test_mono_odom_against_reference(mono_frames, monkeypatch):
    jcfg, tcfg = _with(_configs(imu=False), use_odom=True)
    ref_slam = JSlam(jcfg)
    ref = _run(ref_slam, mono_frames, odom=True)
    JaxDraws().install(monkeypatch)
    slam = SlamSystem(tcfg, "cpu")
    port = _run(slam, mono_frames, odom=True)
    _hold(port, ref, mono_frames)
    after = len(mono_frames) - port["init"] - 1
    assert port["reads"] == ref["reads"] == after
    assert slam.n_odom_frames == after
    assert slam._odom_queue == [] and ref_slam._odom_queue == []


N_PLAIN = 24


def test_mono_icp_lidar_is_plain_mono(mono_frames, monkeypatch):
    frames = mono_frames[:N_PLAIN]
    plain = _configs(imu=False)
    fused = _with(plain, use_icp=True, use_lidar=True)
    refs = [_run(JSlam(c), frames) for c in (plain[0], fused[0])]
    ports = []
    for c in (plain[1], fused[1]):
        monkeypatch.setattr(TR, "_sample_minimal_sets", JaxDraws().sets)
        slam = SlamSystem(c, "cpu")
        ports.append(_run(slam, frames))
    assert slam.n_icp_accepted == 0
    assert all(n == 0 for _, n in slam.plane_factor_counts)
    assert slam.lidar_map is not None and not bool(slam.lidar_map.valid.any())
    for a, b in (refs, ports):
        assert a["states"] == b["states"] and a["init"] is not None
        assert a["stats"] == b["stats"]
        assert [t for t, _ in a["traj"]] == [t for t, _ in b["traj"]]
        for (_, pa), (_, pb) in zip(a["traj"], b["traj"]):
            np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                       atol=1e-6)
    assert ports[1]["states"] == refs[1]["states"]


@pytest.mark.slow
def test_mono_inertial_of_against_reference(monkeypatch):
    """track_monocular_inertial with use_of beside the reference through the
    IMU initialization: the same mono init frame, IMU init frame and states
    up to it."""
    frames = _frames(N_MI, scale=1.2, imu=True)
    jcfg, tcfg = _with(_configs(imu=True), n_of=N_OF, use_of=True)
    ref = _run_until_imu_init(JSlam(jcfg), frames)
    JaxDraws().install(monkeypatch)
    slam = SlamSystem(tcfg, "cpu")
    port = _run_until_imu_init(slam, frames)
    assert port["init"] == ref["init"]
    assert port["imu_init"] == ref["imu_init"] is not None
    assert port["states"] == ref["states"]
    assert slam.of_appended[0] > 5


def _diffs(a, b, frames):
    """Per-frame distances (m) between two runs' trajectories, each aligned
    to ground truth in 7 DoF, over their common stamps."""
    gt = [(f["t"], f["gt"]) for f in frames]
    a, b = _aligned(a["traj"], gt), _aligned(b["traj"], gt)
    return np.array([np.linalg.norm(a[t] - b[t])
                     for t in sorted(set(a) & set(b))])


@pytest.mark.slow
@pytest.mark.parametrize("stream", ["of", "odom"])
def test_mono_streams_rounding_envelope(mono_frames, monkeypatch, stream):
    """Why the OF and odometry parity tests bound the largest per-frame
    difference by MAX_DIFF and not by 2 x the reference's ATE: the scene
    amplifies rounding-level changes. The port against itself with its
    monocular triangulation in float32 (the reference's precision) in
    place of float64, on the same draws, parts on single frames by at
    least half as much as it parts from the reference (9.6 against 15.6 cm
    with OF, 15.6 against 13.8 cm with odometry), and both stay under
    MAX_DIFF. The float32 port does not come nearer the reference
    (12.9 and 15.0 cm): float64 is not the cause."""
    odom = stream == "odom"
    kw = dict(n_of=N_OF, use_of=True) if stream == "of" else dict(
        use_odom=True)
    jcfg, tcfg = _with(_configs(imu=False), **kw)
    ref = _run(JSlam(jcfg), mono_frames, odom=odom)
    JaxDraws().install(monkeypatch)
    port = _run(SlamSystem(tcfg, "cpu"), mono_frames, odom=odom)
    monkeypatch.undo()
    JaxDraws().install(monkeypatch)
    monkeypatch.setattr(TMI.triangulate, "triangulate_points_f64",
                        TRI.triangulate_points)
    monkeypatch.setattr(TLM, "triangulate_points_f64",
                        TRI.triangulate_points)
    port32 = _run(SlamSystem(tcfg, "cpu"), mono_frames, odom=odom)
    to_ref = _diffs(port, ref, mono_frames).max()
    to_self = _diffs(port, port32, mono_frames).max()
    to_ref32 = _diffs(port32, ref, mono_frames).max()
    print(f"{stream}: largest per-frame difference, port vs reference "
          f"{to_ref:.4f} m, port vs float32 port {to_self:.4f} m, float32 "
          f"port vs reference {to_ref32:.4f} m")
    assert port32["states"] == port["states"]
    assert to_self >= 0.5 * to_ref, (to_self, to_ref)
    assert max(to_ref, to_self, to_ref32) < MAX_DIFF


# m: the JAX package's 7-DoF ATE on the card configuration at 640x480,
# the reading that chip_smoke.MONO_GEOFLOW_ATE is set from
REF_ATE_640 = 0.06182


@pytest.mark.slow
@pytest.mark.parametrize("scale", [0.5, 1.0], ids=["320x240", "640x480"])
def test_mono_geoflow_card_config(scale):
    import chip_smoke
    fps = chip_smoke.MONO_FPS
    tcfg = chip_smoke.mono_geoflow_config(scale)
    orb = tcfg.frame.orb
    jcfg = JSys(frame=JFrame(orb=JOrb(**dataclasses.asdict(orb)), bf=0.0,
                             n_of_slots=256),
                **{k: getattr(tcfg, k) for k in ("fx", "fy", "cx", "cy",
                                                 "bf", "sensor", "use_of",
                                                 "use_odom")})
    cam = JS.Camera(fx=tcfg.fx, fy=tcfg.fy, cx=tcfg.cx, cy=tcfg.cy,
                    width=orb.width, height=orb.height)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=fps)
    frames = []
    for i in range(120):
        g, _, (rot_cw, t_cw) = seq.frame(i / fps)
        rwc = np.asarray(rot_cw, np.float64).T
        twc = np.eye(4)
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ np.asarray(t_cw, np.float64)
        frames.append(dict(t=i / fps, gray=np.array(g), gt=twc))
    ref = _run(JSlam(jcfg), frames, odom=True)
    port = _run(SlamSystem(tcfg, "cpu"), frames, odom=True)
    assert port["init"] == ref["init"] is not None
    assert port["states"] == ref["states"]
    assert abs(port["stats"]["n_kfs"] - ref["stats"]["n_kfs"]) <= 1
    gt = [(f["t"], f["gt"]) for f in frames]
    ates = {}
    for name, run in (("ref", ref), ("port", port)):
        n = len(run["traj"]) * 3 // 4
        ates[name] = ate_rmse(run["traj"][-n:], gt[-n:],
                              with_scale=True)["ate_rmse"]
    print(f"{orb.width}x{orb.height}: 7-DoF ATE over the last 3/4", ates)
    if scale == 0.5:
        assert ates["ref"] < 0.06 and ates["port"] < 0.06, ates
    else:
        # the reference misses 6 cm here too; the card's gate is its
        # reading plus 5 mm
        assert abs(ates["ref"] - REF_ATE_640) < 1e-5, ates
        assert REF_ATE_640 + 0.005 == chip_smoke.MONO_GEOFLOW_ATE
        assert ates["port"] < chip_smoke.MONO_GEOFLOW_ATE, ates
