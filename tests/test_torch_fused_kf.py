"""The port's fused keyframe step (SlamSystem._insert_keyframe_fused, the
deferred KF results of _drain_deferred, the host slot mirror) against the
JAX package's (_insert_keyframe_fused, _drain_deferred, _host_slot_mirror)
on the CPU, both façades on their default fused path (the JAX one with
pkt_max_pending=0: synchronous, as the other slice tests run it).

The room of the synthetic sequence at 320x240, 300 features, 4 levels,
10 fps, a KF every one or two frames, a vocabulary that JAX builds from
three frames of the scene, LoopConfig(), and k_max 10, so that KFs are
culled and their slots taken again:

* (a) `local_mapping.mapping_step`, in its local-BA form and in its VI-BA
  form (a window of the map's KFs with preintegrated segments of synthetic
  samples), matches JAX's `mapping_step` on the converted inputs (every
  KF pose within 1 mm and 0.05 deg, the culled slot equal, the valid
  map-point count within 2%: tests/test_torch_tracking.py's bounds) and
  makes no operation that synchronises with the host on CUDA
  (geoflowslam_tpu_torch/utils/sync_audit.py); nor does the façade's fused
  KF insertion when the mirror is clean, visual and with the IMU.
* (b) on every frame of the run, the same slot for each KF generation,
  each cull applied on the same frame, the same valid BoW entries, the
  same `_culled_rel` keys; T_culled<-parent within 1e-4 of the reference's
  while the two maps agree (every KF position within 1e-5 m when the cull
  is applied), and within tests/test_torch_tracking.py's 1 mm KF-pose
  bound once they have parted: a tracked keypoint whose binding flips on a
  near-tie, which tests/test_torch_fused_step.py's 99% obs_mp bound
  allows, moves the next KF's BA by a few tenths of a millimetre; the
  exported poses within max(2 cm, the reference's ATE).
* (c) is tests/test_torch_fused_kf_merge.py (the Atlas break and merge
  of tests/test_e2e_loop.py on the fused path).
* (d) on the same run, stopped fewer than `fused_lag` frames after a KF
  (a KF lands every one or two frames): `map_stats`, `trajectory`,
  `save_atlas`, the staged entry (a frame in localization mode) and
  `shutdown` apply every deferred result as JAX's do (the same culls and
  BoW entries after each, nothing left deferred), `reset_active_map` and
  `reset` drop them as JAX's do, and the frames after each go on as JAX's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geoflowslam_tpu.imu import preintegration as JPRE
from geoflowslam_tpu.io.synthetic import (Camera, SyntheticSequence,
                                          SyntheticWorld)
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline import local_mapping as JLM
from geoflowslam_tpu.pipeline import loop_closing as JLC
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.inertial import InertialTracker as JTracker
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.solvers import inertial_ba as VIBA
from geoflowslam_tpu_torch.utils.sync_audit import audit

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
K_MAX = 10
CPU = "cpu"
# the run: (frame index, what is called on both systems after it)
CHECKS = {11: "map_stats", 15: "trajectory", 19: "save_atlas",
          23: "staged", 27: "reset_active_map", 34: "reset"}
N_FRAMES = 40


def _configs(**kw):
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=K_MAX,
              m_max=4096, kf_min_interval=1, kf_max_interval=2, **kw)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 loop=JLC.LoopConfig(), **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           loop=C.LoopConfig(), **sc))


def _frame(seq, t):
    g, d, (r, tc) = seq.frame(t)
    r = np.asarray(r, np.float64)
    twc = np.eye(4)
    twc[:3, :3] = r.T
    twc[:3, 3] = -r.T @ np.asarray(tc, np.float64)
    return np.array(g), np.array(d), twc


@pytest.fixture(scope="module")
def scene():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    desc = []
    for t in (0.0, 0.7, 1.4):
        fs = extract(torch.from_numpy(_frame(seq, t)[0]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    voc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    frames = [(i / FPS, *_frame(seq, i / FPS)) for i in range(N_FRAMES)]
    return frames, voc


def _host(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def _snapshot(slam, culls, i):
    """What (b) holds on every frame: generation -> slot, the culls applied
    on this frame, the valid BoW entries, the culled-parent keys."""
    return dict(
        slots={g: s for s, g in slam._kf_gen.items()},
        culls=sorted(c for f, c, _, _ in culls if f == i),
        bow=_host(slam.reloc_db.valid).astype(bool).tolist(),
        culled_rel=sorted(slam._culled_rel))


def _after_check(slam, what, tmp, tag):
    if what == "map_stats":
        return slam.map_stats()
    if what == "trajectory":
        return len(slam.trajectory)
    if what == "save_atlas":
        slam.save_atlas(str(tmp / f"atlas_{tag}"))
        return None
    if what == "reset_active_map":
        slam.reset_active_map()
        return None
    if what == "reset":
        slam.reset()
        return None
    raise AssertionError(what)


def _drive(slam, frames, tmp, tag):
    """The run: every frame, its snapshot; after each frame of CHECKS, the
    check's call and (name, len(_deferred) after it, its result); the
    staged entry is the frame's image again, 50 ms later, in localization
    mode (which the façade never fuses)."""
    culls, snaps, checks = [], [], []
    on_culled = slam._on_kf_culled
    frame_no = [0]

    def record(culled):
        culled = int(culled)
        culls.append((frame_no[0], culled, slam._kf_gen.get(culled),
                      _host(slam.ms.kf_t)))
        return on_culled(culled)
    slam._on_kf_culled = record
    for i, (t, g, d, _) in enumerate(frames):
        frame_no[0] = i
        slam.track_rgbd(g, d, t)
        what = CHECKS.get(i)
        if what == "staged":
            # the staged entry: a frame that the façade does not fuse
            slam.activate_localization_mode()
            frame_no[0] = i + 0.5
            slam.track_rgbd(g, d, t + 0.05)
            slam.deactivate_localization_mode()
            checks.append((what, len(slam._deferred), slam.state.name))
        elif what is not None:
            out = _after_check(slam, what, tmp, tag)
            checks.append((what, len(slam._deferred), out))
        snaps.append(_snapshot(slam, culls, i))
    return dict(culls=culls, snaps=snaps, checks=checks)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    frames, voc = scene
    tmp = tmp_path_factory.mktemp("fused_kf")
    jcfg, tcfg = _configs()
    calls = []
    orig = JLM.mapping_step

    def rec(*a, **k):
        out = orig(*a, **k)
        calls.append((a, out))
        return out
    JLM.mapping_step = rec
    try:
        ref = JSlam(jcfg, vocab=voc)
        rj = _drive(ref, frames, tmp, "jax")
    finally:
        JLM.mapping_step = orig
    rj["traj"] = dict((round(t, 4), np.asarray(p)) for t, p in ref.trajectory)
    rj["rel"] = {k: np.asarray(v[2], np.float64)
                 for k, v in ref._culled_rel.items()}
    ref.shutdown(str(tmp / "jax_out"))

    port = SlamSystem(tcfg, CPU, vocab=convert.vocabulary(voc, CPU))
    hits, n_clean = [], [0]
    insert = port._insert_keyframe_fused

    def audited(*a, **k):
        # the insertions that neither found the mirror dirty nor had to
        # resync it (every slot taken in the mirror: the capacity check)
        if port._mirror_dirty:
            return insert(*a, **k)
        n_sync = port.n_mirror_syncs
        with audit(sites=True) as h:
            out = insert(*a, **k)
        if port.n_mirror_syncs == n_sync:
            n_clean[0] += 1
            hits.extend(h)
        return out
    port._insert_keyframe_fused = audited
    rt = _drive(port, frames, tmp, "port")
    rt["traj"] = dict((round(t, 4), p) for t, p in port.trajectory)
    rt["rel"] = {k: np.asarray(v[2], np.float64)
                 for k, v in port._culled_rel.items()}
    rt["audit"] = (n_clean[0], hits)
    port.shutdown(str(tmp / "port_out"))
    rt["deferred_after_shutdown"] = len(port._deferred)
    return dict(ref=rj, port=rt, frames=frames, tmp=tmp, jcfg=jcfg,
                mapping_call=calls[5])


def test_fused_kf_insertion_makes_no_host_sync(runs):
    n, hits = runs["port"]["audit"]
    assert n >= 8, n
    assert hits == [], hits


def test_fused_kf_run_matches_the_reference_frame_by_frame(runs):
    """(b): slots by generation, culls, BoW entries and culled-parent keys
    equal on every frame; T_culled<-parent within 1e-4."""
    ref, port = runs["ref"], runs["port"]
    assert len(ref["culls"]) >= 3, ref["culls"]
    for i, (a, b) in enumerate(zip(ref["snaps"], port["snaps"])):
        assert a == b, (i, a, b)
    assert [c[:3] for c in ref["culls"]] == [c[:3] for c in port["culls"]]
    assert set(ref["rel"]) == set(port["rel"]) and ref["rel"]
    n_agree = 0
    for (_, slot, gen, kf_t_r), (_, _, _, kf_t_p) in zip(ref["culls"],
                                                         port["culls"]):
        if (slot, gen) not in ref["rel"]:
            continue
        d = np.abs(port["rel"][slot, gen] - ref["rel"][slot, gen]).max()
        if np.abs(kf_t_r - kf_t_p).max() <= 1e-5:
            n_agree += 1
            assert d <= 1e-4, (slot, gen, d)
        else:
            assert d <= 1e-3, (slot, gen, d)
    assert n_agree >= 2, n_agree


def test_fused_kf_run_exports_the_reference_poses(runs):
    frames = runs["frames"]
    rt, pt = runs["ref"]["traj"], runs["port"]["traj"]
    assert set(rt) == set(pt)
    gt = [(round(t, 4), twc) for t, _, _, twc in frames]
    bound = max(0.02, ate_rmse([(t, rt[t]) for t, _ in gt if t in rt],
                               gt)["ate_rmse"])
    for t, a in rt.items():
        assert np.linalg.norm(a[:3, 3] - pt[t][:3, 3]) < bound, t


def test_forced_drains_and_clears_match_the_reference(runs):
    """(d): after each check nothing is left deferred, in both packages, and
    what it returned agrees (map_stats' map-point count within 2%)."""
    ref, port = runs["ref"]["checks"], runs["port"]["checks"]
    assert [c[0] for c in ref] == [c[0] for c in port] == [
        CHECKS[i] for i in sorted(CHECKS)]
    for (what, n_r, out_r), (_, n_p, out_p) in zip(ref, port):
        assert n_r == n_p == 0, (what, n_r, n_p)
        if what == "map_stats":
            assert {k: v for k, v in out_r.items() if k != "n_mps"} == {
                k: v for k, v in out_p.items() if k != "n_mps"}
            assert abs(out_r["n_mps"] - out_p["n_mps"]) <= 0.02 * out_r[
                "n_mps"]
        else:
            assert out_r == out_p, (what, out_r, out_p)
    assert runs["port"]["deferred_after_shutdown"] == 0
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
        a = np.loadtxt(runs["tmp"] / "jax_out" / name)
        b = np.loadtxt(runs["tmp"] / "port_out" / name)
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:, 0], b[:, 0], atol=1e-6)
        assert np.abs(a[:, 1:4] - b[:, 1:4]).max() < 0.02


# -- (a) the mapping step ----------------------------------------------------

def _vi_inputs(ms_j, kf_slot, jcfg):
    """A VI-BA window over the map's newest KFs ending at kf_slot, with
    segments preintegrated from synthetic samples (gravity plus noise,
    the frame gap), padded to kw 8."""
    times = np.asarray(ms_j.kf_time)
    valid = np.asarray(ms_j.kf_valid)
    order = [int(s) for s in np.argsort(times) if valid[s] and s != kf_slot]
    slots = order[-4:] + [kf_slot]
    kw = 8
    tracker = JTracker(JImu())
    rng = np.random.default_rng(3)
    for s in slots[1:]:
        n = 20
        acc = np.zeros((32, 3), np.float32)
        gyro = np.zeros((32, 3), np.float32)
        dts = np.zeros(32, np.float32)
        acc[:n] = [0.0, 0.0, 9.81]
        acc[:n] += 0.05 * rng.standard_normal((n, 3))
        gyro[:n] = 0.01 * rng.standard_normal((n, 3))
        dts[:n] = 0.2 / n
        tracker.kf_preints[s] = JPRE.preintegrate(
            jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
            jnp.zeros(6), tracker.calib)
    slots_p = np.asarray(slots + [jcfg.k_max] * (kw - len(slots)), np.int32)
    slot_valid = np.arange(kw) < len(slots)
    segs = tracker.build_segments(list(slots_p))
    return tracker, slots_p, slot_valid, segs, kw


def _hold_mapping(out_j, out_t, kf_slot):
    ms_j, _, _, kr_j, kt_j, sc_j = out_j
    ms_t, _, _, kr_t, kt_t, culled_t, _ = out_t
    assert int(np.asarray(sc_j)[0]) == int(culled_t)
    valid = np.asarray(ms_j.kf_valid)
    np.testing.assert_array_equal(valid, ms_t.kf_valid.numpy())
    for k in np.flatnonzero(valid):
        assert np.linalg.norm(np.asarray(ms_j.kf_t[k])
                              - ms_t.kf_t[k].numpy()) < 1e-3, k
        c = (np.trace(np.asarray(ms_j.kf_rot[k], np.float64)
                      @ ms_t.kf_rot[k].numpy().astype(np.float64).T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 0.05, k
    n_j = int(np.asarray(ms_j.mp_valid).sum())
    assert abs(n_j - int(ms_t.mp_valid.sum())) <= 0.02 * n_j
    assert np.linalg.norm(np.asarray(kt_j) - kt_t.numpy()) < 1e-3


@pytest.mark.parametrize("form", ["local_ba", "vi_ba"])
def test_mapping_step_matches_the_reference_without_host_syncs(runs, form):
    """(a): the sixth mapping step of the reference's run, on the state it
    ran on, in both forms."""
    jcfg, (args, out_j) = runs["jcfg"], runs["mapping_call"]
    (ms_j, frame_j, rot, t, time_rel, obs, ref_kf, kf_slot) = args[:8]
    kf_slot, ref_kf = int(kf_slot), int(ref_kf)
    _, tcfg = _configs()
    vi = None
    if form == "vi_ba":
        tracker, slots_p, slot_valid, segs, kw = _vi_inputs(ms_j, kf_slot,
                                                            jcfg)
        vel = np.asarray([0.05, 0.0, 0.1], np.float32)
        bias = np.zeros(6, np.float32)
        out_j = JLM.mapping_step(
            ms_j, frame_j, rot, t, time_rel, obs, jnp.int32(ref_kf),
            jnp.int32(kf_slot), vel, bias, slots_p, slot_valid, segs,
            tracker.r_cb, tracker.t_cb,
            np.asarray(tracker.walk_info, np.float32), None,
            jcfg.track_cfg(), jcfg.map_cfg(), kw, True)
        vi = (torch.from_numpy(vel), torch.from_numpy(bias), TLM.VIWindow(
            slots=torch.from_numpy(slots_p).long(),
            slot_valid=torch.from_numpy(slot_valid),
            segs=VIBA.ImuSegments(**{
                f: torch.from_numpy(np.array(getattr(segs, f)))
                for f in VIBA.ImuSegments._fields}),
            r_cb=torch.from_numpy(np.array(tracker.r_cb)),
            t_cb=torch.from_numpy(np.array(tracker.t_cb)),
            walk_info=torch.from_numpy(
                np.asarray(tracker.walk_info, np.float32))))

    def port_step():
        return TLM.mapping_step(
            convert.map_state(ms_j, CPU), convert.frame_data(frame_j, CPU),
            convert.to_tensor(rot, CPU), convert.to_tensor(t, CPU),
            float(time_rel), convert.to_tensor(obs, CPU), ref_kf, kf_slot,
            tcfg.track_cfg(), tcfg.map_cfg(), vi=vi)
    port_step()          # fills the per-device constant caches
    ms_in = convert.map_state(ms_j, CPU)
    fr, r_, t_, o_ = (convert.frame_data(frame_j, CPU),
                      convert.to_tensor(rot, CPU), convert.to_tensor(t, CPU),
                      convert.to_tensor(obs, CPU))
    with audit(sites=True) as hits:
        out_t = TLM.mapping_step(ms_in, fr, r_, t_, float(time_rel), o_,
                                 ref_kf, kf_slot, tcfg.track_cfg(),
                                 tcfg.map_cfg(), vi=vi)
    assert hits == [], hits
    _hold_mapping(out_j, out_t, kf_slot)


def test_fused_kf_insertion_with_the_imu_makes_no_host_sync():
    """The façade's fused KF step with the IMU (its VI window staged
    through pinned memory), once the mirror is clean: no operation that
    synchronises with the host on CUDA. The port alone: 30 frames of its
    synthetic room with 200 Hz samples, the IMU initialized on the way."""
    cam = TS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = TS.SyntheticSequence(TS.SyntheticWorld(cam, device=CPU), fps=FPS)
    orb = C.OrbConfig(n_features=300, n_levels=4, height=H, width=W)
    cfg = C.SystemConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=12, m_max=4096,
        kf_min_interval=1, kf_max_interval=2,
        frame=C.FrameConfig(orb=orb, lk_levels=3, cloud_stride=8,
                            cloud_max_pts=1024, bf=20.0),
        imu=C.ImuConfig(init_min_kfs=4, init_min_time=0.5))
    slam = SlamSystem(cfg, CPU)
    hits, n_vi = [], [0]
    insert = slam._insert_keyframe_fused

    def audited(*a, **k):
        if slam._mirror_dirty:
            return insert(*a, **k)
        n_sync, vi = slam.n_mirror_syncs, len(slam.imu.contiguous_window(8))
        with audit(sites=True) as h:
            out = insert(*a, **k)
        if slam.n_mirror_syncs == n_sync:
            n_vi[0] += vi >= 2
            hits.extend(h)
        return out
    slam._insert_keyframe_fused = audited
    for i in range(30):
        g, d, _ = seq.frame(i / FPS)
        if i == 0:
            slam.track_rgbd(g, d, 0.0)
        else:
            slam.track_rgbd_inertial(g, d, *seq.imu_between(
                (i - 1) / FPS, i / FPS, 32), i / FPS)
    assert slam.imu.initialized and slam.state.name == "OK"
    assert n_vi[0] >= 4, n_vi
    assert hits == [], hits

