"""The façade's default recovery (the JAX package's fused path) against the
JAX SlamSystem on its default path (pkt_max_pending=0: synchronous), and
its pieces against the JAX functions they mirror:

* the scenario of tests/test_fused_recovery.py (320x240, 300 features, a
  vocabulary built from three frames of the scene): a map, blank frames
  that lose it (a long time_recently_lost, so no new map), a revisit of
  mapped views, more frames. Both systems must go RECENTLY_LOST on >= 4
  blank frames, relocalize back into the same map (1 map, state OK,
  n_lost >= 4) and insert keyframes again;
* pipeline/reloc.recover_frame on the JAX system's map and state at the
  first revisit frame, converted, from its own prediction (a 40 px
  re-search holds) and from that prediction turned 35 deg away (the
  re-search fails: a relocalization), against the JAX composition of the
  same steps (track_with_motion_model at 40 px from the predicted pose,
  reloc_core, the selection and the max(min_inliers_ok, 30) gate of
  geoflowslam_tpu/pipeline/fused.py), both fed the same PnP RANSAC draws:
  the same stage chosen, inliers equal, the pose within 1 mm and 0.05 deg;
* tracking.mean_reproj_error on the same map, frame and bindings;
* the KF-stall watchdog against the JAX method on one timestamp sequence.
"""
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.ops import matching as JM
from geoflowslam_tpu.ops import ransac as JR
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.ops.gms import gms_filter
from geoflowslam_tpu.pipeline import tracking as JT
from geoflowslam_tpu.pipeline.reloc import reloc_core as j_reloc_core
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import kf_database as JDB
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline import reloc as TR
from geoflowslam_tpu_torch.pipeline import tracking as TT
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.pipeline.system import TrackingState
from geoflowslam_tpu_torch.state.frame import build_frame
from test_torch_shared import shared_result
from tests.test_torch_slice_reloc import _jax_frame, _rot_deg

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
N_A, N_BLANK, N_RE = 22, 8, 6


def _configs():
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=32,
              m_max=4096, kf_min_interval=1, kf_max_interval=2,
              time_recently_lost=30.0)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           **sc))


def _frame(seq, t):
    g, d, _ = seq.frame(t)
    return np.array(g), np.array(d)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _scene():
    """The JAX-rendered sequence and the vocabulary (k = 8, 2 levels) JAX
    builds from three of its frames; the port's extractor gives the
    descriptors (bit-equal, tests/test_torch_frontend.py)."""
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for t in (0.0, 0.7, 1.4):
        fs = extract(torch.from_numpy(_frame(seq, t)[0]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    return seq, voc


def _drive(slam, seq, snapshot=None):
    """tests/test_fused_recovery.py's frames; `snapshot(slam)` sees the
    system just before the first revisit frame."""
    out = {}
    for i in range(N_A):
        slam.track_rgbd(*_frame(seq, i / FPS), i / FPS)
    out["a"] = slam.map_stats()
    blank = np.full((H, W), 100.0, np.float32)
    bdepth = np.full((H, W), 2.0, np.float32)
    out["n_lost_seen"] = 0
    for i in range(N_BLANK):
        slam.track_rgbd(blank, bdepth, 2.2 + i / FPS)
        out["n_lost_seen"] += slam.state.name == "RECENTLY_LOST"
    out["maps_lost"] = slam.map_stats()["n_maps"]
    if snapshot is not None:
        snapshot(slam)
    for i in range(N_RE):
        slam.track_rgbd(*_frame(seq, (4 + i) / FPS), 3.2 + i / FPS)
    out["re"] = slam.map_stats()
    out["n_lost"] = slam.n_lost
    for i in range(N_RE, 2 * N_RE):
        slam.track_rgbd(*_frame(seq, (4 + i) / FPS), 3.2 + i / FPS)
    out["end"] = slam.map_stats()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX run's outcomes and its state before the first revisit
    frame, once per session for every xdist worker
    (tests/test_torch_shared.py)."""
    return shared_result(tmp_path_factory,
                         "test_torch_fused_recovery.reference", _reference)


def _reference():
    seq, jvoc = _scene()
    jcfg, _ = _configs()
    ref = JSlam(jcfg, vocab=jvoc)
    snap = {}

    def snapshot(s):
        snap.update(ms=s.ms, db=s.reloc_db, last_obs=s.last_obs_mp,
                    cur=(s.cur_rot, s.cur_t), vel=s.vel, has_vel=s.has_vel,
                    levels=s._last_levels, ref_kf=s.ref_kf)
    out = _drive(ref, seq, snapshot)
    out.update(snap=snap)
    return out


@pytest.fixture(scope="module")
def port(scene):
    seq, jvoc = scene
    _, tcfg = _configs()
    slam = SlamSystem(tcfg, "cpu", vocab=convert.vocabulary(jvoc, "cpu"))
    out = _drive(slam, seq)
    out.update(slam=slam)
    return out


def _gates(run):
    assert run["a"]["n_kfs"] >= 6 and run["a"]["state"] == "OK", run["a"]
    assert run["n_lost_seen"] >= 4, run["n_lost_seen"]
    assert run["maps_lost"] == 1
    assert run["re"]["state"] == "OK" and run["re"]["n_maps"] == 1, run["re"]
    assert run["n_lost"] >= 4
    assert run["end"]["state"] == "OK", run["end"]
    assert run["end"]["n_kfs"] >= run["re"]["n_kfs"]


def test_reference_recovers(reference):
    _gates(reference)


def test_port_recovers_as_the_reference(reference, port):
    _gates(port)
    slam = port["slam"]
    assert slam._fused_mode()
    # the first blank frame goes RECENTLY_LOST at once, as the reference's
    assert port["n_lost_seen"] == reference["n_lost_seen"] == N_BLANK
    assert port["end"]["n_maps"] == reference["end"]["n_maps"] == 1


def _j_sample_sets(jvoc, db, ms, jframe, key):
    """reloc_core's PnP draws on the JAX side: its candidates, per-candidate
    keys and valid masks (as tests/test_torch_slice_reloc.py draws them)."""
    feat = jframe.feat
    qvec = JV.bow_vector(jvoc, JV.descend(jvoc, feat.desc, feat.valid))
    idx, _, ok = JDB.detect_relocalization_candidates(db, ms, qvec, 3)
    keys = jax.random.split(key, 3)
    sets = []
    for b in range(3):
        kf = int(idx[b])
        m_idx, _ = JM.match_descriptors(
            feat.desc, feat.valid, ms.kf_desc[kf],
            ms.kf_kp_valid[kf] & (ms.kf_obs_mp[kf] >= 0),
            max_dist=JM.TH_LOW, ratio=0.85, mutual=True)
        m_idx = gms_filter(feat.uv, ms.kf_uv[kf], m_idx, (W, H), (W, H))
        mp = ms.kf_obs_mp[kf][jnp.maximum(m_idx, 0)]
        valid = ((m_idx >= 0) & (mp >= 0) & ms.mp_valid[jnp.maximum(mp, 0)]
                 & ok[b])
        sets.append(np.asarray(JR._sample_minimal_sets(keys[b], valid, 128,
                                                       6)))
    return torch.from_numpy(np.stack(sets)).long()


@pytest.mark.parametrize("turn,stage", [(0.0, "re-search"), (0.6, "reloc")])
def test_recover_frame_matches_the_fused_step(scene, reference, turn,
                                              stage):
    seq, jvoc = scene
    snap = reference["snap"]
    jcfg, tcfg = _configs()
    jtrk, ttrk = jcfg.track_cfg(), tcfg.track_cfg()
    min_ok = jcfg.min_inliers_ok
    ms, db = snap["ms"], snap["db"]
    g, d = _frame(seq, 0.4)
    tframe = build_frame(torch.from_numpy(g), torch.from_numpy(d),
                         tcfg.frame, FX, FX, W / 2, H / 2)
    jframe = _jax_frame(tframe)
    cur_r, cur_t = snap["cur"]
    assert snap["has_vel"]
    pr, pt = JL.se3_compose(snap["vel"][0], snap["vel"][1], cur_r, cur_t)
    pr, pt = JL.se3_compose(JL.so3_exp(jnp.asarray([0.0, turn, 0.0])),
                            jnp.zeros(3), pr, pt)

    # the JAX composition (fused.py's _try_reloc and its gate)
    wide = dataclasses.replace(jtrk, search_radius_mm=40.0)
    resw = JT.track_with_motion_model(ms, jframe, snap["last_obs"], pr, pt,
                                      wide, last_levels=snap["levels"])
    key = jax.random.PRNGKey(7777)
    n_r, r_r, t_r, _, cand_r = jax.jit(
        lambda db, ms, fr, k: j_reloc_core(jvoc, db, ms, fr, k, jtrk, W, H,
                                           FX, FX, W / 2, H / 2))(
        db, ms, jframe, key)
    use_w = int(resw.n_inliers) >= min_ok
    assert use_w == (stage == "re-search")
    n_j = int(resw.n_inliers) if use_w else int(n_r)
    rot_j, t_j = (resw.rot, resw.t) if use_w else (r_r, t_r)
    kf_j = snap["ref_kf"] if use_w else int(cand_r)

    sets = _j_sample_sets(jvoc, db, ms, jframe, key)
    tvoc = convert.vocabulary(jvoc, "cpu")
    tdb, tms = convert.kf_database(db, "cpu"), convert.map_state(ms, "cpu")
    calls = []

    def relocalize(f):
        calls.append(1)
        return TR.reloc_core(tvoc, tdb, tms, f, None, ttrk, W, H,
                             sample_sets=sets)
    c = lambda x: convert.to_tensor(x, "cpu")               # noqa: E731
    rec = TR.recover_frame(tms, tframe, c(snap["last_obs"]), c(pr), c(pt),
                           snap["ref_kf"], c(snap["levels"]), ttrk, min_ok,
                           relocalize)
    assert n_j >= max(min_ok, 30), n_j      # the reference adopts it
    assert bool(rec.adopted)
    # both stages run, as the reference's, and the choice is the same
    assert calls == [1]
    assert bool(rec.relocalized) == (not use_w)
    assert int(rec.n_inliers) == n_j, (int(rec.n_inliers), n_j)
    assert int(rec.kf) == kf_j
    assert np.linalg.norm(rec.t.numpy() - np.asarray(t_j)) < 1e-3
    assert _rot_deg(rec.rot.numpy(), rot_j) < 0.05


def test_mean_reproj_error_matches_reference(scene, reference):
    """The mean reprojection error of the first revisit frame's 40 px
    re-search bindings, and of the pose moved 2 cm, on the reference's map:
    within 1e-4 px of the JAX function."""
    seq, _ = scene
    snap = reference["snap"]
    jcfg, tcfg = _configs()
    jtrk = jcfg.track_cfg()
    g, d = _frame(seq, 0.4)
    tframe = build_frame(torch.from_numpy(g), torch.from_numpy(d),
                         tcfg.frame, FX, FX, W / 2, H / 2)
    jframe = _jax_frame(tframe)
    cur_r, cur_t = snap["cur"]
    res = JT.track_with_motion_model(
        snap["ms"], jframe, snap["last_obs"], cur_r, cur_t,
        dataclasses.replace(jtrk, search_radius_mm=40.0),
        last_levels=snap["levels"])
    assert int(res.n_inliers) >= jcfg.min_inliers_ok
    tms = convert.map_state(snap["ms"], "cpu")
    c = lambda x: convert.to_tensor(x, "cpu")               # noqa: E731
    for dt in (0.0, 0.02):
        t_off = res.t + jnp.asarray([dt, 0.0, 0.0])
        want = float(JT.mean_reproj_error(snap["ms"], jframe, res.obs_mp,
                                          res.rot, t_off, jtrk))
        got = float(TT.mean_reproj_error(tms, tframe, c(res.obs_mp),
                                         c(res.rot), c(t_off),
                                         tcfg.track_cfg()))
        assert abs(got - want) < 1e-4, (dt, got, want)
        assert (want > 1.0) == (dt > 0)


def test_kf_watchdog_matches_reference():
    """The same KF times and frame stamps through both methods on stubs:
    the same count of warnings at the same frames; in localization mode
    neither warns."""
    def stub():
        return types.SimpleNamespace(
            _last_kf_time=0.0, _last_stall_warn=-1e18, kf_stall_warnings=0,
            frames_since_kf=0, _carried_streak=0, _localization_only=False)
    j, t = stub(), stub()
    kf_at = {5.0, 30.0, 31.0, 62.5}
    trace_j, trace_t = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for ts in np.arange(0.0, 80.0, 0.25):
            for s, fn, trace in ((j, JSlam._kf_watchdog, trace_j),
                                 (t, SlamSystem._kf_watchdog, trace_t)):
                if float(ts) in kf_at:
                    s._last_kf_time = float(ts)
                fn(s, float(ts))
                trace.append((s.kf_stall_warnings, s._last_stall_warn))
    assert trace_j == trace_t
    assert t.kf_stall_warnings == 6
    with pytest.warns(UserWarning, match="KF-stall"):
        SlamSystem._kf_watchdog(t, 200.0)
    j._localization_only = t._localization_only = True
    JSlam._kf_watchdog(j, 400.0)
    SlamSystem._kf_watchdog(t, 400.0)
    assert (j.kf_stall_warnings, t.kf_stall_warnings) == (6, 7)


def test_failed_frame_holds_pose_motion_model_and_bindings(scene, port):
    """One more blank frame on the port after its run: the pose, the motion
    model and the bindings stay as they were, the state goes RECENTLY_LOST
    and the frame is not exported."""
    slam = port["slam"]
    assert slam.state == TrackingState.OK
    before = (slam.cur_rot.clone(), slam.cur_t.clone(),
              slam.vel[0].clone(), slam.vel[1].clone(),
              slam.last_obs_mp.clone(), slam.has_vel)
    n_lost = slam.n_lost
    t = 10.0
    slam.track_rgbd(np.full((H, W), 100.0, np.float32),
                    np.full((H, W), 2.0, np.float32), t)
    assert slam.state == TrackingState.RECENTLY_LOST
    assert slam.n_lost == n_lost + 1
    after = (slam.cur_rot, slam.cur_t, slam.vel[0], slam.vel[1],
             slam.last_obs_mp, slam.has_vel)
    for a, b in zip(before[:5], after[:5]):
        assert torch.equal(a, b)
    assert before[5] == after[5]
    assert t not in [s for s, _ in slam.trajectory]
