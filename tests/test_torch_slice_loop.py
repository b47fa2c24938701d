"""The port's loop-closing slice end to end: an Atlas break and merge, as
tests/test_e2e_loop.py stages it (320x240, 300 features, a vocabulary that
JAX builds from three frames of the scene and convert.py hands to the port).

Phase A builds a map, blank frames lose it until a second Atlas map starts,
and phase C revisits phase A's views, which place recognition, Sim3
verification and the merge weld back into one map. The port and a JAX
SlamSystem run the same frames; both must meet test_e2e_loop.py's gates
(state OK, a merge or loop, >= 90% of the KFs in the active map) and end
with the same number of maps, and the port's poses on tracked frames stay
within max(2 cm, the reference's own ATE) of the reference's.

Both run their staged path (record_reproj_err=True keeps each off its
fused recovery; the reference with pkt_max_pending=0): loop detection at
the KF and relocalization on every lost frame.
Its fused path lags loop detection by fused_lag frames and exports the
poses of its in-dispatch recovery frames even when they are metres off, so
it is no yardstick here. The staged path drops the motion model after each
local BA, which the port (like the fused path) keeps, so the two are held
to each other by outcomes and a pose bound, not frame by frame. Its loop
closer is instrumented from the outside to record the inputs of every
detect step, of the verified candidate and of the global BA it starts,
which the port's detect_step, verify_sim3 (fed the reference's RANSAC
draws), correct_loop and AsyncGBA then replay on the converted state.

`scene`, `frame` and `configs` are shared with test_torch_slice_reloc.py.
"""
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
from geoflowslam_tpu.pipeline import local_mapping as JLM
from geoflowslam_tpu.pipeline import loop_closing as JLC
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state import map_state as JMS
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.ops import gicp as G
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.pipeline import loop_closing as TLC
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
N_A, N_BLANK, N_C = 16, 6, 8          # phase A, blank (max), revisit frames
LOOP = dict(min_sim3_inliers=15, min_score=0.02)


def scene():
    """The JAX-rendered sequence and the vocabulary JAX builds (k = 8, 2
    levels) from the ORB descriptors of three of its frames. The port's
    extractor computes those descriptors: its bits equal the reference's
    (tests/test_torch_frontend.py) at a fraction of the eager JAX cost."""
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for t in (0.0, 0.7, 1.4):
        fs = extract(torch.from_numpy(frame(seq, t)[0]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    return seq, voc


def frame(seq, t):
    """(gray, depth, ground-truth Twc) of the view at time t."""
    g, d, (r, tc) = seq.frame(t)
    r = np.asarray(r, np.float64)
    twc = np.eye(4)
    twc[:3, :3] = r.T
    twc[:3, 3] = -r.T @ np.asarray(tc, np.float64)
    return np.array(g), np.array(d), twc


def configs(k_max=24, loop=None, **kw):
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=k_max,
              m_max=4096, kf_min_interval=1, kf_max_interval=2, **kw)
    jcfg = JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                record_reproj_err=True,
                loop=JLC.LoopConfig(**loop) if loop else None, **sc)
    tcfg = C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                          record_reproj_err=True,
                          loop=C.LoopConfig(**loop) if loop else None, **sc)
    return jcfg, tcfg


def _views():
    """(timestamp, view time) of phase A and phase C."""
    return ([(i / FPS, i / FPS) for i in range(N_A)]
            + [(N_A / FPS + 1.0 + i / FPS, i / FPS) for i in range(N_C)])


def _steps(seq, slam):
    """Phase A, blank frames until a second map starts, phase C."""
    views = _views()
    for t, v in views[:N_A]:
        yield (t,) + frame(seq, v)[:2]
    blank = np.full((H, W), 100.0, np.float32)
    bdepth = np.full((H, W), 2.0, np.float32)
    for i in range(N_BLANK):
        if slam.map_stats()["n_maps"] >= 2:
            break
        yield N_A / FPS + i / FPS, blank, bdepth
    for t, v in views[N_A:]:
        yield (t,) + frame(seq, v)[:2]


def _kf_share(kf_valid, kf_map_id, active):
    maps = np.asarray(kf_map_id)[np.asarray(kf_valid)]
    return float((maps == int(active)).mean())


@pytest.fixture(scope="module")
def world():
    seq, jvoc = scene()
    gt = {round(t, 4): frame(seq, v)[2] for t, v in _views()}
    return seq, jvoc, gt


@pytest.fixture(scope="module")
def reference(world):
    seq, jvoc, _ = world
    jcfg, _ = configs(time_recently_lost=0.25, min_kfs_for_new_map=6,
                      loop=LOOP)
    ref = JSlam(jcfg, vocab=jvoc)
    lc = ref.loop_closer
    detects, verifies = [], []
    detect, complete = lc._detect, lc.complete_candidate

    def record_detect(ms, kf_slot):
        pre = (lc.db, ms, int(kf_slot), lc._groups, lc._counts)
        out = detect(ms, kf_slot)
        detects.append(pre + (np.asarray(out), lc.db, lc._groups,
                              lc._counts))
        return out

    def record_complete(ms, cur, best, **kw):
        key = lc.key
        out = complete(ms, cur, best, **kw)
        verifies.append((ms, int(cur), int(best), key, out[1]))
        return out

    gba_starts = []
    gba_start = ref._gba.start

    def record_gba_start(ms):
        gba_starts.append(ms)
        return gba_start(ms)

    lc._detect = record_detect
    lc.complete_candidate = record_complete
    ref._gba.start = record_gba_start
    for t, g, d in _steps(seq, ref):
        ref.track_rgbd(g, d, t)
    return dict(slam=ref, detects=detects, verifies=verifies,
                gba_starts=gba_starts,
                traj=dict((round(t, 4), np.asarray(p))
                          for t, p in ref.trajectory))


@pytest.fixture(scope="module")
def port(world):
    seq, jvoc, _ = world
    _, tcfg = configs(time_recently_lost=0.25, min_kfs_for_new_map=6,
                      loop=LOOP)
    slam = SlamSystem(tcfg, "cpu", vocab=convert.vocabulary(jvoc, "cpu"))
    for t, g, d in _steps(seq, slam):
        twc = slam.track_rgbd(g, d, t)
        assert twc.shape == (4, 4) and np.all(np.isfinite(twc))
    return dict(slam=slam, traj=dict((round(t, 4), p)
                                     for t, p in slam.trajectory))


def _gates(st, n_events, share):
    assert st["state"] == "OK", st
    assert n_events >= 1, st
    assert share > 0.9, (share, st)


def test_reference_meets_its_gates(reference):
    ref = reference["slam"]
    ms = ref.ms
    _gates(ref.map_stats(), ref.loop_closer.n_loops + ref.loop_closer.n_merges,
           _kf_share(ms.kf_valid, ms.kf_map_id, ms.active_map))


def test_port_meets_the_gates_and_tracks_the_reference(world, reference,
                                                       port):
    _, _, gt = world
    slam, ref = port["slam"], reference["slam"]
    st = slam.map_stats()
    _gates(st, slam.loop_closer.n_loops + slam.loop_closer.n_merges,
           _kf_share(slam.ms.kf_valid, slam.ms.kf_map_id,
                     slam.ms.active_map))
    assert slam.loop_closer.n_merges == ref.loop_closer.n_merges
    assert st["n_maps"] == ref.map_stats()["n_maps"] >= 2
    rt, pt = reference["traj"], port["traj"]
    bound = max(0.02, ate_rmse(list(rt.items()), list(gt.items()))[
        "ate_rmse"])
    common = sorted(set(rt) & set(pt))
    assert len(common) >= N_A + N_C - 4, (len(rt), len(pt))
    for t in common:
        err = np.linalg.norm(rt[t][:3, 3] - pt[t][:3, 3])
        assert err < bound, (t, err, bound)


def test_detect_step_matches_reference(world, reference):
    """Every KF's place recognition on the converted state: candidates,
    chain counts and groups exact, scores and the inserted BoW row within
    1e-6 (a score of 1 - 6e-8 reads 9999 where 1.0 reads 10000)."""
    _, jvoc, _ = world
    tvoc = convert.vocabulary(jvoc, "cpu")
    cfg = reference["slam"].cfg.loop
    assert len(reference["detects"]) >= 6
    for db, ms, slot, groups, counts, want, db2, g2, c2 in reference[
            "detects"]:
        tdb, groups_t, counts_t, scal = TLC.detect_step(
            tvoc, convert.kf_database(db, "cpu"), convert.map_state(ms, "cpu"),
            slot, convert.to_tensor(groups, "cpu"),
            convert.to_tensor(counts, "cpu"), cfg.min_score, 3)
        # candidates and chain counts exact; the score (x 1e4, truncated)
        # may differ by one where float sums of the BoW rows differ last-bit
        np.testing.assert_array_equal(scal.numpy()[:, :2], want[:, :2])
        assert np.abs(scal.numpy()[:, 2] - want[:, 2]).max() <= 1
        np.testing.assert_array_equal(groups_t.numpy(), np.asarray(g2))
        np.testing.assert_array_equal(counts_t.numpy(), np.asarray(c2))
        np.testing.assert_allclose(tdb.bow.numpy(), np.asarray(db2.bow),
                                   atol=1e-6, rtol=0)
    assert max(int(r[5][:, 1].max()) for r in reference["detects"]) >= 3


def _rot_deg(ra, rb):
    c = (np.trace(np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T)
         - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@pytest.fixture(scope="module")
def verified(reference):
    """The reference's verification of the candidate it closed, and the
    port's on the converted state with the same Sim3 RANSAC draws."""
    ref = reference["slam"]
    lc = ref.loop_closer
    ms, cur, cand, key, _ = next(v for v in reference["verifies"] if v[4])
    _, k = jax.random.split(key)
    scal_j, s_j, r_j, t_j = JLC._verify_sim3_fused(
        ms, jnp.int32(cur), jnp.int32(cand), k, lc.cfg.fix_scale,
        lc._map_cfg)
    m_idx, _ = JM.match_descriptors(
        ms.kf_desc[cur], ms.kf_kp_valid[cur] & (ms.kf_obs_mp[cur] >= 0),
        ms.kf_desc[cand], ms.kf_kp_valid[cand] & (ms.kf_obs_mp[cand] >= 0),
        max_dist=JM.TH_LOW, ratio=0.85, mutual=True)
    mp2 = ms.kf_obs_mp[cand][jnp.maximum(m_idx, 0)]
    valid = (m_idx >= 0) & (ms.kf_obs_mp[cur] >= 0) & (mp2 >= 0)
    sets = JR._sample_minimal_sets(k, valid, 64, 3)
    _, tcfg = configs(loop=LOOP)
    tms = convert.map_state(ms, "cpu")
    scal_t, s_t, r_t, t_t = TLC.verify_sim3(
        tms, cur, cand, None, lc.cfg.fix_scale, tcfg.map_cfg(),
        sample_sets=torch.from_numpy(np.array(sets)).long())
    return dict(ms=ms, cur=cur, cand=cand, j=(scal_j, s_j, r_j, t_j),
                t=(scal_t, s_t, r_t, t_t))


def test_verify_sim3_matches_reference(reference, verified):
    lc = reference["slam"].loop_closer
    (scal_j, s_j, r_j, t_j), (scal_t, s_t, r_t, t_t) = (verified["j"],
                                                        verified["t"])
    scal_j, scal_t = np.asarray(scal_j), scal_t.numpy()
    # RANSAC, GN and projection counts exact; thickness in whole mm
    np.testing.assert_array_equal(scal_t[:3], scal_j[:3])
    assert abs(int(scal_t[3]) - int(scal_j[3])) <= 1
    gate = lambda s: (s[0] >= lc.cfg.min_sim3_inliers                # noqa
                      and s[1] >= lc.cfg.min_sim3_inliers
                      and s[2] >= lc.cfg.min_proj_verify
                      and s[3] >= 1e3 * lc.cfg.min_structure_m)
    assert bool(gate(scal_t)) == bool(gate(scal_j)) is True
    assert abs(float(s_t) - float(s_j)) < 1e-4
    assert np.linalg.norm(t_t.numpy() - np.asarray(t_j)) < 1e-3
    assert _rot_deg(r_t.numpy(), r_j) < 0.05


@pytest.fixture(scope="module")
def corrected(reference, verified):
    """Merge then the essential-graph correction, from the reference's
    verified Sim3, on both sides."""
    lc = reference["slam"].loop_closer
    ms, cur, cand = verified["ms"], verified["cur"], verified["cand"]
    _, s, rot, t = verified["j"]
    r1, t1 = ms.kf_rot[cur], ms.kf_t[cur]
    r2, t2 = ms.kf_rot[cand], ms.kf_t[cand]
    merged = JMS.merge_maps(ms, ms.kf_map_id[cur], ms.kf_map_id[cand], s,
                            r2.T @ rot @ r1, r2.T @ (s * (rot @ t1) + t - t2))
    want = lc._correct_loop(merged, cur, cand, s, rot, t)
    got = TLC.correct_loop(
        convert.map_state(merged, "cpu"), cur, cand,
        *(convert.to_tensor(x, "cpu") for x in (s, rot, t)),
        C.LoopConfig(**LOOP))
    return merged, want, got


def test_correct_loop_matches_reference(corrected):
    """KF poses within 1 mm and 0.05 deg, points within 1 mm."""
    merged, want, got = corrected
    valid = np.asarray(want.kf_valid)
    assert valid.sum() >= 8
    np.testing.assert_allclose(got.kf_t.numpy()[valid],
                               np.asarray(want.kf_t)[valid], atol=1e-3,
                               rtol=0)
    for k in np.flatnonzero(valid):
        assert _rot_deg(got.kf_rot[k].numpy(), want.kf_rot[k]) < 0.05
    mp = np.asarray(want.mp_valid)
    np.testing.assert_allclose(got.mp_pos.numpy()[mp],
                               np.asarray(want.mp_pos)[mp], atol=1e-3,
                               rtol=0)
    moved = np.abs(np.asarray(want.kf_t) - np.asarray(merged.kf_t))[valid]
    assert moved.max() > 1e-4


def test_async_global_ba_matches_reference(reference):
    """The global BA the merge started, finished on the final state: the
    reference's AsyncGBA runs its remaining micro-steps; the port's starts
    from the same (converted) snapshot and runs all of them. KFs inserted
    after the snapshot take the correction through the temporal chain.
    KF poses within 1 mm and 0.05 deg, points within 1 cm."""
    ref = reference["slam"]
    g = ref._gba
    assert g.active and len(reference["gba_starts"]) == 1
    start_ms, final_ms = reference["gba_starts"][0], ref.ms
    new_kfs = (np.asarray(final_ms.kf_valid)
               & ~np.asarray(start_ms.kf_valid)).sum()
    while not g.step():
        pass
    want = g.finish(final_ms)
    _, tcfg = configs(loop=LOOP)
    tg = TLM.AsyncGBA(tcfg.map_cfg())
    tg.start(convert.map_state(start_ms, "cpu"))
    n = 1
    while not tg.step():
        n += 1
    assert n == g.iters_total
    got = tg.finish(convert.map_state(final_ms, "cpu"))
    valid = np.asarray(want.kf_valid)
    assert new_kfs >= 1 and valid.sum() >= 8
    np.testing.assert_allclose(got.kf_t.numpy()[valid],
                               np.asarray(want.kf_t)[valid], atol=1e-3,
                               rtol=0)
    for k in np.flatnonzero(valid):
        assert _rot_deg(got.kf_rot[k].numpy(), want.kf_rot[k]) < 0.05
    mp = np.asarray(want.mp_valid)
    np.testing.assert_allclose(got.mp_pos.numpy()[mp],
                               np.asarray(want.mp_pos)[mp], atol=1e-2,
                               rtol=0)
    moved = np.abs(np.asarray(want.kf_t) - np.asarray(final_ms.kf_t))[valid]
    assert moved.max() > 1e-4


def test_fuse_pair_matches_reference(reference, verified, corrected):
    """The seam weld on the corrected state (the reference's, converted):
    the same observations and map-point validity, exactly."""
    cur, cand = verified["cur"], verified["cand"]
    ms = corrected[1]
    mcfg = reference["slam"].loop_closer._map_cfg
    want = JLM.fuse_pair(ms, jnp.int32(cur), jnp.int32(cand), mcfg)
    _, tcfg = configs(loop=LOOP)
    got = TLM.fuse_pair(convert.map_state(ms, "cpu"), cur, cand,
                        tcfg.map_cfg())
    np.testing.assert_array_equal(got.kf_obs_mp.numpy(),
                                  np.asarray(want.kf_obs_mp))
    np.testing.assert_array_equal(got.mp_valid.numpy(),
                                  np.asarray(want.mp_valid))
    assert int(np.asarray(ms.mp_valid).sum()) > int(
        np.asarray(want.mp_valid).sum())          # it fused something


def test_global_ba_step_matches_reference(reference):
    """LoopConfig.run_global_ba's synchronous global BA on the reference's
    final (merged) state: KF poses within 1 mm and 0.05 deg, points within
    1 cm."""
    ms = reference["slam"].ms
    mcfg = reference["slam"].loop_closer._map_cfg
    want = JLM.global_ba_step(ms, mcfg)
    _, tcfg = configs(loop=LOOP)
    got = TLM.global_ba_step(convert.map_state(ms, "cpu"), tcfg.map_cfg())
    valid = np.asarray(want.kf_valid)
    np.testing.assert_allclose(got.kf_t.numpy()[valid],
                               np.asarray(want.kf_t)[valid], atol=1e-3,
                               rtol=0)
    for k in np.flatnonzero(valid):
        assert _rot_deg(got.kf_rot[k].numpy(), want.kf_rot[k]) < 0.05
    mp = np.asarray(want.mp_valid)
    np.testing.assert_allclose(got.mp_pos.numpy()[mp],
                               np.asarray(want.mp_pos)[mp], atol=1e-2,
                               rtol=0)
    moved = np.abs(np.asarray(want.kf_t) - np.asarray(ms.kf_t))[valid]
    assert moved.max() > 1e-5


def test_icp_loop_takes_the_registration(world, verified, monkeypatch):
    """use_icp_loop: given both KFs' depth clouds, the correction uses the
    GICP registration of the current KF's cloud onto the candidate's,
    started from the verified Sim3, at unit scale."""
    ms, cur, cand = verified["ms"], verified["cur"], verified["cand"]
    _, s, rot, t = verified["t"]
    rs = np.random.RandomState(0)
    c1 = torch.from_numpy((rs.rand(512, 3) * [2.0, 1.5, 1.0]
                           + [-1.0, -0.75, 1.5]).astype(np.float32))
    true_rot = torch.from_numpy(np.asarray(JL.so3_exp(
        jnp.asarray([0.01, -0.02, 0.015], jnp.float32)))) @ rot
    true_t = t + torch.tensor([0.02, -0.01, 0.03])
    c2 = c1 @ true_rot.T + true_t
    ok = torch.ones(512, dtype=torch.bool)
    used = {}

    def spy(ms_, cur_, cand_, s_, rot_, t_, cfg, yaw_only=False):
        used.update(s=s_, rot=rot_, t=t_)
        return ms_
    monkeypatch.setattr(TLC, "correct_loop", spy)
    _, tcfg = configs(loop=LOOP)
    lc = TLC.LoopCloser(convert.vocabulary(world[1], "cpu"), tcfg.k_max,
                        C.LoopConfig(**LOOP, use_icp_loop=True,
                                     run_weld=False),
                        map_cfg=tcfg.map_cfg(), device="cpu")
    monkeypatch.setattr(lc, "_verify",
                        lambda *a: (True, s, rot, t, 100, 100))
    _, found = lc.complete_candidate(convert.map_state(ms, "cpu"), cur,
                                     cand, kf_clouds={cur: (c1, ok),
                                                      cand: (c2, ok)})
    want = G.gicp_register(c1, ok, c2, ok, init_rot=rot, init_t=t)
    assert found and lc.n_merges == 1
    assert float(used["s"]) == 1.0
    assert torch.equal(used["rot"], want.rot)
    assert torch.equal(used["t"], want.t)
    assert _rot_deg(used["rot"].numpy(), true_rot.numpy()) < 0.05
    assert float(torch.linalg.norm(used["t"] - true_t)) < 1e-3


def test_drift_budget_gate(world, verified):
    """A same-map loop's implied correction E = T_meas T_odom^-1 must stay
    within floor + rate * |t_cur - t_cand|: the odometry itself passes, a
    1 m, a 10 deg or a x1.3 correction does not."""
    ms = convert.map_state(verified["ms"], "cpu")
    cur, cand = verified["cur"], verified["cand"]
    _, tcfg = configs(loop=LOOP)
    lc = TLC.LoopCloser(convert.vocabulary(world[1], "cpu"), tcfg.k_max,
                        C.LoopConfig(**LOOP), map_cfg=tcfg.map_cfg(),
                        device="cpu")
    r1, t1 = ms.kf_rot[cur], ms.kf_t[cur]
    r2, t2 = ms.kf_rot[cand], ms.kf_t[cand]
    r_o = r2 @ r1.T
    t_o = t2 - r_o @ t1
    one = torch.ones(())
    assert lc._within_drift_budget(ms, cur, cand, one, r_o, t_o)
    yaw = torch.from_numpy(np.asarray(JL.so3_exp(
        jnp.asarray([0.0, np.radians(10.0), 0.0], jnp.float32))))
    for s, rot, t in ((one, r_o, t_o + torch.tensor([1.0, 0.0, 0.0])),
                      (one, yaw @ r_o, yaw @ t_o), (1.3 * one, r_o, t_o)):
        with pytest.warns(UserWarning, match="drift budget"):
            assert not lc._within_drift_budget(ms, cur, cand, s, rot, t)
