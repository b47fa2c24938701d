"""The port's relocalization slice end to end, as
tests/test_reloc_observability.py stages it (320x240, 300 features, the
scene's own vocabulary built by JAX and converted): build a map, tilt the
camera in place by 90 degrees down to the floor (the last reference KF then
shares no view with the start), lose it on blank frames (time_recently_lost large, no
new-map escape), then revisit an early view with image noise. Neither the
motion model nor TrackReferenceKeyFrame can recover that view, so the
recovery is a relocalization. The port and a JAX SlamSystem (both on their
staged path, see test_torch_slice_loop.py) run the same frames. Both must
relocalize without a new map and, after three clean frames, sit within
10 cm of their own first-pass pose at that view; they end with the same
number of maps. The port's poses on tracked frames stay within max(2 cm,
the reference's own ATE) of the reference's before the loss, and within
the larger of that and 3 cm after the recovery, where each tracker restarts
from its own map and the staged reference also without its motion model (it drops
it after every local BA; the port keeps it, as the fused path does).

reloc_core itself is then replayed on the reference's map at the moment of
the first noisy frame, converted, with a BoW database holding every KF: the
best candidate's inlier gate must agree and its pose be within 1 mm and
0.05 deg of the reference's, both sides fed the same PnP RANSAC draws. On
the port's own map it returns exactly what the per-candidate order it
replaced returns (each candidate matched on its own, then the rest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops import matching as JM
from geoflowslam_tpu.ops import ransac as JR
from geoflowslam_tpu.ops.extractor import FeatureSet as JFeat
from geoflowslam_tpu.ops.gms import gms_filter
from geoflowslam_tpu.pipeline import tracking as JT
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.retrieval import kf_database as JDB
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameData as JFrameData

from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.ops import matching as TM
from geoflowslam_tpu_torch.pipeline import reloc as TR
from geoflowslam_tpu_torch.pipeline import tracking as TT
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.retrieval import kf_database as TDB
from geoflowslam_tpu_torch.retrieval import vocab as TV
from geoflowslam_tpu_torch.state.frame import build_frame
from tests.test_torch_slice_loop import FPS, H, W, configs, frame, scene

torch.set_num_threads(2)

N_A, N_BLANK = 16, 3        # first-pass and blank frames
N_TILT, TILT = 16, np.pi / 2  # the tilt down to the floor after it
T_RE = 0.4                  # the revisited view
RELOC = dict(time_recently_lost=30.0, min_kfs_for_new_map=99)


@pytest.fixture(scope="module")
def world():
    seq, jvoc = scene()
    gt = {round(t, 4): _view(seq, v)[2] for t, v in _views()}
    noisy_g, noisy_d, _ = frame(seq, T_RE)
    rng = np.random.default_rng(7)
    noisy_g = np.clip(noisy_g + rng.normal(0, 6.0, noisy_g.shape), 0,
                      255).astype(np.float32)
    return seq, jvoc, gt, (noisy_g, noisy_d)


def _view(seq, v):
    """(gray, depth, ground-truth Twc) of view v: a time on the trajectory,
    or (pitch,) for the camera at the first pass's last view tilted down by
    pitch about the world's x axis (the floor is at +y)."""
    if not isinstance(v, tuple):
        return frame(seq, v)
    twc = frame(seq, (N_A - 1) / FPS)[2]
    c, s = np.cos(v[0]), np.sin(v[0])
    twc[:3, :3] = np.array([[1, 0, 0], [0, c, s], [0, -s, c]]) @ twc[:3, :3]
    rot_cw = twc[:3, :3].T
    g, d = seq.world.render(jnp.asarray(rot_cw, jnp.float32),
                            jnp.asarray(-rot_cw @ twc[:3, 3], jnp.float32))
    return np.array(g), np.array(d), twc


def _t_lost():
    """Timestamp of the first blank frame."""
    return (N_A + N_TILT) / FPS


def _views():
    """(timestamp, view) of the first pass, the tilt (eased in and out over
    N_TILT frames), the noisy revisit frames and the clean frames after
    them."""
    return ([(i / FPS, i / FPS) for i in range(N_A)]
            + [((N_A + k) / FPS,
                (TILT * (1 - np.cos(np.pi * (k + 1) / N_TILT)) / 2,))
               for k in range(N_TILT)]
            + [(_t_lost() + 1.0 + i / FPS, T_RE) for i in range(3)]
            + [(_t_lost() + 1.5 + i / FPS, T_RE + i / FPS)
               for i in range(1, 4)])


def _drive(slam, world, snapshot=None):
    """First pass, the tilt, blank frames, up to 3 noisy revisit frames,
    3 clean frames. `snapshot(tag, slam)` sees the system after the first
    pass ("first") and after the blank frames ("lost"). Returns the
    first-pass poses, whether the revisit came back to OK, the inliers of
    the tracking fallbacks on the frame that did (below min_inliers_ok when
    relocalization recovered it), the stats after the noisy frames and the
    final pose at the last clean view."""
    seq, _, _, (noisy_g, noisy_d) = world
    views = _views()
    first = {}
    for t, v in views[:N_A]:
        first[round(t, 4)] = slam.track_rgbd(*_view(seq, v)[:2], t).copy()
    if snapshot is not None:
        snapshot("first", slam)
    for t, v in views[N_A:N_A + N_TILT]:
        slam.track_rgbd(*_view(seq, v)[:2], t)
    blank = np.full((H, W), 100.0, np.float32)
    bdepth = np.full((H, W), 2.0, np.float32)
    for i in range(N_BLANK):
        slam.track_rgbd(blank, bdepth, _t_lost() + i / FPS)
    lost_state = slam.map_stats()["state"]
    if snapshot is not None:
        snapshot("lost", slam)
    ok, tracked = False, None
    for t, _ in views[N_A + N_TILT:N_A + N_TILT + 3]:
        slam.track_rgbd(noisy_g, noisy_d, t)
        if slam.map_stats()["state"] == "OK":
            ok, tracked = True, slam.inlier_log[-1][2]
            break
    for t, v in views[-3:]:
        pose = slam.track_rgbd(*_view(seq, v)[:2], t)
    return dict(first=first, lost_state=lost_state, ok=ok, tracked=tracked,
                stats=slam.map_stats(), pose=pose,
                traj=dict((round(t, 4), np.asarray(p))
                          for t, p in slam.trajectory))


@pytest.fixture(scope="module")
def reference(world):
    jcfg, _ = configs(**RELOC)
    ref = JSlam(jcfg, vocab=world[1])
    snap = {}

    def snapshot(tag, s):
        if tag == "first":
            snap.update(first_ms=s.ms, last=(s.cur_rot, s.cur_t),
                        ref_kf=s.ref_kf)
        else:
            snap.update(ms=s.ms)
    out = _drive(ref, world, snapshot)
    out.update(slam=ref, **snap)
    return out


@pytest.fixture(scope="module")
def port(world):
    _, tcfg = configs(**RELOC)
    slam = SlamSystem(tcfg, "cpu", vocab=convert.vocabulary(world[1], "cpu"))
    out = _drive(slam, world)
    out.update(slam=slam)
    return out


def _gates(run, min_ok):
    assert run["lost_state"] == "RECENTLY_LOST", run["lost_state"]
    assert run["ok"], run["stats"]
    # the fallbacks failed on the recovering frame: relocalization did it
    assert run["tracked"] < min_ok, run["tracked"]
    assert run["stats"]["state"] == "OK" and run["stats"]["n_maps"] == 1
    ref_pose = run["first"][round(T_RE + 3 / FPS, 4)]
    err = np.linalg.norm(run["pose"][:3, 3] - ref_pose[:3, 3])
    assert err < 0.1, err


def test_reference_meets_its_gates(reference):
    _gates(reference, reference["slam"].cfg.min_inliers_ok)


def test_port_meets_the_gates_and_tracks_the_reference(world, reference,
                                                       port):
    _gates(port, port["slam"].cfg.min_inliers_ok)
    assert port["slam"].n_reloc >= 1
    # record_reproj_err logs both stages of every tracked frame, as the
    # reference's staged path does
    ps, rs = port["slam"], reference["slam"]
    assert len(ps.f2f_reproj) == len(ps.f2m_reproj) == len(rs.f2f_reproj) > 0
    assert port["stats"]["n_maps"] == reference["stats"]["n_maps"]
    gt = world[2]
    rt, pt = reference["traj"], port["traj"]
    bound = max(0.02, ate_rmse(list(rt.items()), list(gt.items()))[
        "ate_rmse"])
    common = sorted(set(rt) & set(pt))
    assert len(common) >= N_A + N_TILT + 3, (len(rt), len(pt))
    for t in common:
        err = np.linalg.norm(rt[t][:3, 3] - pt[t][:3, 3])
        # after the recovery the two trackers restart from their own maps,
        # and the staged reference without its motion model: at least 3 cm
        # there. Measured: 3.9 cm before the loss and 5.7 cm after it,
        # against a bound (the reference's ATE) of 6.1 cm
        assert err < (bound if t < _t_lost() else max(bound, 0.03)), (
            t, err, bound)


def _rot_deg(ra, rb):
    c = (np.trace(np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T)
         - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _jax_frame(tf):
    """The reference's FrameData holding the port frame's values (the two
    frame builders agree, tests/test_torch_frontend.py)."""
    j = lambda x: jnp.asarray(x.numpy())                         # noqa
    feat = JFeat(**{f: j(getattr(tf.feat, f)) for f in JFeat._fields})
    return JFrameData(
        feat=feat._replace(desc=jnp.asarray(
            tf.feat.desc.numpy().view(np.uint32))),
        depth_kp=j(tf.depth_kp), u_right=j(tf.u_right), cloud=j(tf.cloud),
        cloud_valid=j(tf.cloud_valid),
        lk_pyramid=tuple(j(x) for x in tf.lk_pyramid))


def test_reloc_core_matches_reference(world, reference):
    ref = reference["slam"]
    jvoc, ms = world[1], reference["ms"]
    noisy_g, noisy_d = world[3]
    _, tcfg = configs(**RELOC)
    tframe = build_frame(torch.from_numpy(noisy_g), torch.from_numpy(noisy_d),
                         tcfg.frame, tcfg.fx, tcfg.fy, tcfg.cx, tcfg.cy)
    jframe = _jax_frame(tframe)
    db = JDB.KFDatabase.create(ms.k_max, jvoc.n_words)
    for slot in np.flatnonzero(np.asarray(ms.kf_valid)):
        db = JDB.add_keyframe(db, jvoc, int(slot), ms.kf_desc[slot],
                              ms.kf_kp_valid[slot])
    key = jax.random.PRNGKey(11)
    n_j, rot_j, t_j, obs_j = ref._reloc_jit(db, ms, jframe, key)

    # the reference's PnP draws: its per-candidate keys and valid masks
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
    assert bool(ok.all())

    n_t, rot_t, t_t, obs_t, cand = TR.reloc_core(
        convert.vocabulary(jvoc, "cpu"), convert.kf_database(db, "cpu"),
        convert.map_state(ms, "cpu"), tframe, None,
        tcfg.track_cfg(), W, H, sample_sets=torch.from_numpy(
            np.stack(sets)).long())
    min_ok = ref.cfg.min_inliers_ok
    assert (int(n_t) >= min_ok) == (int(n_j) >= min_ok) is True
    assert abs(int(n_t) - int(n_j)) <= 2, (int(n_t), int(n_j))
    assert int(cand) in np.asarray(idx).tolist()
    assert np.linalg.norm(t_t.numpy() - np.asarray(t_j)) < 1e-3
    assert _rot_deg(rot_t.numpy(), rot_j) < 0.05
    same = (obs_t.numpy() == np.asarray(obs_j)).mean()
    assert same > 0.98, same


def test_reloc_core_batched_match_keeps_the_per_candidate_result(world,
                                                                  port):
    """reloc_core matches all three candidates in one batched search (one
    K4 launch on the card). On the port's map at the end of its run, for the
    noisy revisit, it returns exactly what the order it replaced returns:
    each candidate matched on its own, then GMS, PnP RANSAC, MLPnP and pose
    GN, the generator drawn in the same order."""
    slam = port["slam"]
    cfg, trk, ms, db = slam.cfg, slam.tcfg, slam.ms, slam.reloc_db
    noisy_g, noisy_d = world[3]
    tframe = build_frame(torch.from_numpy(noisy_g), torch.from_numpy(noisy_d),
                         cfg.frame, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    got = TR.reloc_core(slam.vocab, db, ms, tframe,
                        torch.Generator().manual_seed(5), trk, W, H)

    gen = torch.Generator().manual_seed(5)
    feat = tframe.feat
    qvec = TV.bow_vector(slam.vocab, TV.descend(slam.vocab, feat.desc,
                                                feat.valid))
    idx, _, ok = TDB.detect_relocalization_candidates(db, ms, qvec, n_best=3)
    uvn = ((feat.uv - torch.tensor([trk.cx, trk.cy]))
           / torch.tensor([trk.fx, trk.fy]))
    res = []
    for kf, okc in zip(idx.tolist(), ok):
        m_idx, _ = TM.match_descriptors(
            feat.desc, feat.valid, ms.kf_desc[kf],
            ms.kf_kp_valid[kf] & (ms.kf_obs_mp[kf] >= 0),
            max_dist=TM.TH_LOW, ratio=0.85, mutual=True)
        res.append(TR.reloc_candidate(ms, tframe, kf, okc, uvn, m_idx, gen,
                                      trk, W, H))
    b = int(torch.argmax(torch.stack([r[0] for r in res])))
    for a, w in zip(got, (*res[b], idx[b])):
        assert torch.equal(a, w)
    assert int(got[0]) >= cfg.min_inliers_ok


def test_track_reference_keyframe_matches_reference(world, reference):
    """TrackReferenceKeyFrame (BoW same-word mask, rotation consistency,
    pose-only GN from the last pose of the first pass, before the tilt) on
    the noisy revisit, on the reference's converted map of that moment:
    inliers within 2, the pose within 1 mm and 0.05 deg."""
    jvoc, ms = world[1], reference["first_ms"]
    ref_kf, (rot0, t0) = reference["ref_kf"], reference["last"]
    noisy_g, noisy_d = world[3]
    jcfg, tcfg = configs(**RELOC)
    tframe = build_frame(torch.from_numpy(noisy_g), torch.from_numpy(noisy_d),
                         tcfg.frame, tcfg.fx, tcfg.fy, tcfg.cx, tcfg.cy)
    jframe = _jax_frame(tframe)
    words = lambda d, v: JV.descend(jvoc, d, v)                  # noqa
    want = JT.track_reference_keyframe(
        ms, jframe, words(jframe.feat.desc, jframe.feat.valid),
        words(ms.kf_desc[ref_kf], ms.kf_kp_valid[ref_kf]), jnp.int32(ref_kf),
        rot0, t0, jcfg.track_cfg())
    tvoc = convert.vocabulary(jvoc, "cpu")
    tms = convert.map_state(ms, "cpu")
    got = TT.track_reference_keyframe(
        tms, tframe, TV.descend(tvoc, tframe.feat.desc, tframe.feat.valid),
        TV.descend(tvoc, tms.kf_desc[ref_kf], tms.kf_kp_valid[ref_kf]),
        ref_kf, convert.to_tensor(rot0, "cpu"), convert.to_tensor(t0, "cpu"),
        tcfg.track_cfg())
    assert int(want.n_inliers) >= jcfg.min_inliers_ok
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    assert np.linalg.norm(got.t.numpy() - np.asarray(want.t)) < 1e-3
    assert _rot_deg(got.rot.numpy(), want.rot) < 0.05
