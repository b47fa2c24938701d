"""The port's checkpoints and façade lifecycle against the JAX package's, on
the test_torch_slice scenario (320x240, 400 features, 4 levels, k_max 24,
m_max 4096, 10 fps; the JAX façade with pkt_max_pending=0, so that its
keyframe decisions are synchronous like the port's):

* atlas round trip in the port: every MapState array and dtype equal;
  SlamSystem.load_atlas puts a new active map on top (n_maps + 1),
  NOT_INITIALIZED, the saved time base;
* the vocabulary checksum of the port's default vocabulary equals the JAX
  digest of the JAX default vocabulary, and the gate raises on a second
  vocabulary (state/serialize and SlamSystem.load_atlas);
* cross-package atlas: a JAX-written atlas loads in the port with all
  arrays equal, and a port-written atlas loads in JAX with all arrays
  equal (descriptor words as uint32);
* cross-package session: JAX tracks 20 RGB-D frames and writes a session;
  a fresh JAX system and a fresh port system load that file (the port's
  map equal to the saved one) and continue 10 frames. Both stay OK, their
  KF counts within 1, every restored frame's position within max(2 cm, 2x
  the JAX continuation's ATE), as the slice tests hold the two packages;
* the port's own session round trip: a fresh system restored from the
  port's file tracks the next 10 frames exactly as the unbroken run
  (positions within 1e-5 m, the same map counts); JAX reads the port's
  session with the same map; a capacity mismatch raises;
* localization mode after the restored continuation, 10 frames in both
  packages: KF counts frozen in both, state OK, positions within the
  slice bound; deactivated, 8 more frames insert KFs again in both;
  then `reset` in both: no KF, NOT_INITIALIZED, one map, and the next frame
  initializes both (positions within the bound);
* the inertial session with loop closing (the test_torch_slice_inertial
  IMU configuration, a vocabulary of the scene and the loop slice's
  LoopConfig): JAX tracks 20 RGB-D-inertial frames and writes a session;
  the port loads it and writes it again, and the two files hold the same
  keys with every array equal in dtype, shape and value (the `ms.*`,
  `sys.*`, `imu.*` bias, body, preintegration segments and raw chunks,
  and the `loop.*` BoW database and consistency chains) and the same
  `imu`, `loop` and `sys` meta; a fresh JAX system loads the port's file;
  both continue 10 frames: OK with the IMU initialized on every frame,
  KF counts within 1, positions within the slice bound;
* local_ba_every_kf=False over 20 RGB-D frames in both packages (the staged
  KF step without local BA): the same states, KF counts within 1,
  positions within the slice bound;
* `shutdown` of the restored systems: the same file names as the JAX
  façade's, the timers' files with the same columns, and the trajectories
  with the same timestamps (the TUM layout; the JAX writers' bytes are
  held by tests/test_torch_io.py).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline import loop_closing as JLC
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state import map_state as JM
from geoflowslam_tpu.state import serialize as JS
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.eval.ate import ate_rmse
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline.system import SlamSystem, TrackingState
from geoflowslam_tpu_torch.retrieval import vocab as V
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state import serialize as S
from test_torch_shared import shared_result

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
N_SAVE, N_CONT, N_LOC, N_AFTER = 20, 10, 10, 8
# test_torch_slice_inertial's IMU configuration, test_torch_slice_loop's
# loop closer
IMU = dict(init_min_kfs=4, init_min_time=0.5)
LOOP = dict(min_sim3_inliers=15, min_score=0.02)


def _configs(imu=None, loop=None, **kw):
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24,
              m_max=4096, **kw)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 imu=JImu(**imu) if imu else None,
                 loop=JLC.LoopConfig(**loop) if loop else None, **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           imu=C.ImuConfig(**imu) if imu else None,
                           loop=C.LoopConfig(**loop) if loop else None, **sc))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """The frames, ground truth and IMU samples, rendered once per session
    for every xdist worker (tests/test_torch_shared.py)."""
    return shared_result(tmp_path_factory, "test_torch_persistence.sequence",
                         _sequence)


def _sequence():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    frames, gt, imu = [], [], [None]
    for i in range(N_SAVE + N_CONT + N_LOC + N_AFTER + 1):
        t = i / FPS
        g, d, (r, tc) = seq.frame(t)
        r = np.asarray(r, np.float64)
        twc = np.eye(4)
        twc[:3, :3] = r.T
        twc[:3, 3] = -r.T @ np.asarray(tc, np.float64)
        frames.append((t, np.array(g), np.array(d)))
        gt.append((t, twc))
        if i > 0 and i <= N_SAVE + N_CONT:
            imu.append(tuple(np.array(x) for x in seq.imu_between(
                (i - 1) / FPS, t, 32)))
    return frames, gt, imu


def _drive(slam, frames):
    """Track the frames; returns {t: position} of the returned poses and
    the states after each frame."""
    pos, states = {}, []
    for t, g, d in frames:
        pos[t] = np.asarray(slam.track_rgbd(g, d, t))[:3, 3]
        states.append(slam.map_stats()["state"])
    return pos, states


def _drive_inertial(slam, frames, imu, first):
    """_drive with the IMU: frame `first + k` gets the samples since the
    frame before it (frame 0 goes through track_rgbd); also checks that
    the IMU stays initialized on every frame when it starts so."""
    pos, states = {}, []
    was_init = slam.imu.initialized
    for k, (t, g, d) in enumerate(frames):
        i = first + k
        twc = (slam.track_rgbd(g, d, t) if i == 0
               else slam.track_rgbd_inertial(g, d, *imu[i], t))
        pos[t] = np.asarray(twc)[:3, 3]
        states.append(slam.map_stats()["state"])
        assert slam.imu.initialized or not was_init, i
    return pos, states


def _close(pa, pb, bound):
    assert pa.keys() == pb.keys()
    for t in pa:
        err = np.linalg.norm(pa[t] - pb[t])
        assert err < bound, (t, err, bound)


def _bound(traj, gt):
    """The slice tests' bound: max(2 cm, 2x the reference's ATE)."""
    return max(0.02, 2 * ate_rmse(traj, gt)["ate_rmse"])


def _assert_ms_equal(port_ms, jax_arrays):
    for f in M.MapState._fields:
        a = S.ms_to_host(port_ms)[f]
        b = np.asarray(jax_arrays[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _random_map(rng, k=6, n=16, m=64):
    ms = M.create(k, n, m, "cpu")
    vals = {}
    for f in ms._fields:
        ref = getattr(ms, f)
        shape = tuple(ref.shape)
        if ref.dtype == torch.bool:
            a = np.asarray(rng.random(shape) < 0.5)
        elif ref.dtype == torch.int32:
            a = np.asarray(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                        dtype=np.int64), np.int32)
        else:
            a = np.asarray(rng.normal(size=shape), np.float32)
        vals[f] = torch.from_numpy(a)
    vals["n_maps"] = torch.tensor(2, dtype=torch.int32)
    return M.MapState(**vals)


def test_atlas_roundtrip(tmp_path):
    ms = _random_map(np.random.default_rng(0))
    p = str(tmp_path / "atlas")
    S.save_atlas(p, ms, extra={"seq": "test", "time_base": 1.4e9})
    ms2, extra = S.load_atlas(p + ".npz", device="cpu")
    assert extra == {"seq": "test", "time_base": 1.4e9}
    ref = M.create(1, 1, 1, "cpu")
    for f in ms._fields:
        assert getattr(ms2, f).dtype == getattr(ref, f).dtype, f
        assert torch.equal(getattr(ms2, f), getattr(ms, f)), f
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, k_max=6, m_max=64, frame=dataclasses
                               .replace(tcfg.frame, orb=dataclasses.replace(
                                   tcfg.frame.orb, n_features=16)))
    slam = SlamSystem(tcfg, "cpu")
    slam.load_atlas(p)
    assert slam.state == TrackingState.NOT_INITIALIZED
    assert slam.time_base == 1.4e9
    assert int(slam.ms.n_maps) == 3 and int(slam.ms.active_map) == 2
    assert torch.equal(slam.ms.kf_desc, ms.kf_desc)


def test_vocab_checksum_equal_and_gate(tmp_path):
    tv = V.default_vocabulary("cpu")
    assert S._vocab_checksum(tv) == JS._vocab_checksum(
        JV.default_vocabulary())
    assert S._vocab_checksum(None) == JS._vocab_checksum(None) == "none"
    train = np.random.default_rng(1).integers(0, 2 ** 32, (500, 8),
                                              dtype=np.uint64)
    v2 = V.build_vocabulary(train.astype(np.uint32), k=4, levels=2, iters=2,
                            seed=0, device="cpu")
    ms = M.create(4, 16, 64, "cpu")
    p = str(tmp_path / "a")
    S.save_atlas(p, ms, vocab=tv)
    S.load_atlas(p + ".npz", vocab=tv, device="cpu")
    with pytest.raises(ValueError, match="checksum"):
        S.load_atlas(p + ".npz", vocab=v2, device="cpu")
    # the JAX package's gate reads the port's digest as its own
    JS.load_atlas(p + ".npz", vocab=JV.default_vocabulary())
    _, tcfg = _configs()
    small = dataclasses.replace(tcfg, k_max=4, m_max=64, frame=dataclasses
                                .replace(tcfg.frame, orb=dataclasses.replace(
                                    tcfg.frame.orb, n_features=16)))
    with pytest.raises(ValueError, match="checksum"):
        SlamSystem(small, "cpu", vocab=v2).load_atlas(p)


def test_cross_package_atlas(tmp_path):
    rng = np.random.default_rng(2)
    k, n, m = 8, 64, 256
    jms = JM.create(k, n, m)
    for slot in (2, 5):
        jms = JM.insert_keyframe(
            jms, jnp.int32(slot), jnp.eye(3),
            jnp.asarray(rng.normal(size=3), jnp.float32),
            jnp.zeros(3), jnp.zeros(6), jnp.float32(1.5 * slot),
            jnp.asarray(rng.uniform(0, 300, (n, 2)), jnp.float32),
            jnp.asarray(rng.integers(0, 4, n), jnp.int32),
            jnp.asarray(rng.normal(size=n), jnp.float32),
            jnp.asarray(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
                        .astype(np.uint32)),
            jnp.asarray(rng.uniform(0.5, 4, n), jnp.float32),
            jnp.asarray(rng.random(n) < 0.8),
            jnp.asarray(rng.integers(-1, m, n), jnp.int32), jnp.int32(-1))
    pj = str(tmp_path / "jax_atlas")
    JS.save_atlas(pj, jms, extra={"seq": "jax"})
    tms, extra = S.load_atlas(pj + ".npz", device="cpu")
    assert extra == {"seq": "jax"}
    _assert_ms_equal(tms, {f: getattr(jms, f) for f in jms._fields})

    pt = str(tmp_path / "port_atlas")
    ms = _random_map(rng)
    S.save_atlas(pt, ms, extra={"seq": "port"})
    jms2, extra = JS.load_atlas(pt + ".npz")
    assert extra == {"seq": "port"}
    _assert_ms_equal(ms, {f: getattr(jms2, f) for f in jms2._fields})


@pytest.fixture(scope="module")
def restored(sequence, tmp_path_factory):
    """_restored's outcomes, once per session for every xdist worker."""
    return shared_result(tmp_path_factory, "test_torch_persistence.restored",
                         lambda: _restored(sequence, tmp_path_factory))


def _restored(sequence, tmp_path_factory):
    """JAX tracks N_SAVE frames and saves a session; a fresh JAX system and
    a fresh port system load it and continue N_CONT frames, then run
    N_LOC frames in localization mode and N_AFTER frames after it, then
    reset and track one frame."""
    frames, gt, _ = sequence
    d = tmp_path_factory.mktemp("session")
    jcfg, tcfg = _configs()
    a = JSlam(jcfg)
    for t, g, dd in frames[:N_SAVE]:
        a.track_rgbd(g, dd, t)
    saved = a.map_stats()
    p = str(d / "jax_session")
    a.save_session(p)
    saved_ms = {f: np.asarray(getattr(a.ms, f)) for f in a.ms._fields}
    out = dict(saved=saved, saved_ms=saved_ms, gt=gt, dir=d)
    b, port = JSlam(jcfg), SlamSystem(tcfg, "cpu")
    b.load_session(p)
    port.load_session(p)
    out["loaded"] = (b.map_stats(), port.map_stats())
    out["loaded_ms"] = S.ms_to_host(port.ms)
    i0, i1 = N_SAVE, N_SAVE + N_CONT
    out["cont"] = (_drive(b, frames[i0:i1]), _drive(port, frames[i0:i1]))
    out["cont_stats"] = (b.map_stats(), port.map_stats())
    out["cont_traj"] = (list(b.trajectory), list(port.trajectory))
    for s, name in ((b, "jax"), (port, "port")):
        s.f2f_reproj.append((1.4e9, 1.25, 31))
        s.shutdown(str(d / f"out_{name}"))
    b.activate_localization_mode()
    port.activate_localization_mode()
    i2 = i1 + N_LOC
    out["loc"] = (_drive(b, frames[i1:i2]), _drive(port, frames[i1:i2]))
    out["loc_stats"] = (b.map_stats(), port.map_stats())
    b.deactivate_localization_mode()
    port.deactivate_localization_mode()
    i3 = i2 + N_AFTER
    out["after"] = (_drive(b, frames[i2:i3]), _drive(port, frames[i2:i3]))
    out["after_stats"] = (b.map_stats(), port.map_stats())
    b.reset()
    port.reset()
    out["reset_stats"] = (b.map_stats(), port.map_stats())
    out["reset_state"] = port.state
    out["reinit"] = (_drive(b, frames[i3:i3 + 1]),
                     _drive(port, frames[i3:i3 + 1]))
    out["reinit_stats"] = (b.map_stats(), port.map_stats())
    return out


def test_cross_package_session(restored):
    r = restored
    jl, tl = r["loaded"]
    assert jl == tl == r["saved"], (jl, tl, r["saved"])
    _assert_ms_equal_arrays(r["loaded_ms"], r["saved_ms"])
    (pj, sj), (pt, st) = r["cont"]
    assert sj == st == ["OK"] * N_CONT, (sj, st)
    cj, ct = r["cont_stats"]
    assert abs(cj["n_kfs"] - ct["n_kfs"]) <= 1, (cj, ct)
    tj, tt = r["cont_traj"]
    assert [t for t, _ in tj] == [t for t, _ in tt]
    _close(pj, pt, _bound(tj, r["gt"]))


def _assert_ms_equal_arrays(a, b):
    for f in M.MapState._fields:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_localization_mode_and_reset(restored):
    r = restored
    (pj, sj), (pt, st) = r["loc"]
    cj, ct = r["cont_stats"]
    lj, lt = r["loc_stats"]
    assert sj == st == ["OK"] * N_LOC, (sj, st)
    assert lj["n_kfs"] == cj["n_kfs"] and lt["n_kfs"] == ct["n_kfs"]
    assert lj["n_mps"] == cj["n_mps"] and lt["n_mps"] == ct["n_mps"]
    bound = _bound(r["cont_traj"][0], r["gt"])
    _close(pj, pt, bound)
    aj, at = r["after_stats"]
    assert aj["n_kfs"] > lj["n_kfs"] and at["n_kfs"] > lt["n_kfs"], (aj, at)
    (pj, sj), (pt, st) = r["after"]
    assert sj == st == ["OK"] * N_AFTER
    _close(pj, pt, bound)
    rj, rt = r["reset_stats"]
    assert rj == rt == {"n_kfs": 0, "n_mps": 0, "n_maps": 1,
                        "state": "NOT_INITIALIZED"}, (rj, rt)
    assert r["reset_state"] == TrackingState.NOT_INITIALIZED
    ij, it = r["reinit_stats"]
    assert ij["state"] == it["state"] == "OK" and ij["n_kfs"] == it["n_kfs"]
    _close(r["reinit"][0][0], r["reinit"][1][0], bound)


def _layout(path):
    """(header line or None, set of field counts of the data lines)."""
    lines = open(path).read().splitlines()
    head = lines[0] if lines and lines[0].startswith("#") else None
    return head, {len(x.replace(",", " ").split()) for x in lines
                  if x and not x.startswith("#")}


def test_shutdown_file_set(restored):
    d = restored["dir"]
    names = sorted(os.listdir(d / "out_jax"))
    assert names == sorted(os.listdir(d / "out_port"))
    for n in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt", "map.html",
              "ExecTimeMean.txt", "LocalMapTimeStats.txt", "LBA_Stats.txt",
              "SessionInfo.txt", "TrackTimeCost.txt",
              "Frame2FrameReprojErr.txt"):
        assert n in names, n
    for n in ("ExecTimeMean.txt", "LocalMapTimeStats.txt", "LBA_Stats.txt",
              "TrackTimeCost.txt", "CameraTrajectory.txt",
              "KeyFrameTrajectory.txt"):
        (hj, cj), (ht, ct) = _layout(d / "out_jax" / n), _layout(
            d / "out_port" / n)
        assert hj == ht and (cj == ct or not cj or not ct), (n, hj, ht,
                                                              cj, ct)
    assert ((d / "out_jax/Frame2FrameReprojErr.txt").read_bytes()
            == (d / "out_port/Frame2FrameReprojErr.txt").read_bytes())
    for n in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
        tj = [line.split()[0] for line in open(d / "out_jax" / n)]
        tt = [line.split()[0] for line in open(d / "out_port" / n)]
        assert tj == tt, n
    info_j = (d / "out_jax/SessionInfo.txt").read_text().splitlines()
    info_t = (d / "out_port/SessionInfo.txt").read_text().splitlines()
    assert [x.split(":")[0] for x in info_j] == [x.split(":")[0]
                                                 for x in info_t]


def test_port_session_roundtrip(sequence, tmp_path):
    frames, _, _ = sequence
    _, tcfg = _configs()
    a = SlamSystem(tcfg, "cpu")
    _drive(a, frames[:N_SAVE])
    p = str(tmp_path / "port_session")
    a.save_session(p)
    saved = a.map_stats()
    cont = slice(N_SAVE, N_SAVE + N_CONT)
    pa, sa = _drive(a, frames[cont])
    b = SlamSystem(tcfg, "cpu")
    b.load_session(p)
    assert b.map_stats() == saved
    pb, sb = _drive(b, frames[cont])
    assert sa == sb and a.map_stats() == b.map_stats()
    _close(pa, pb, 1e-5)
    j = JSlam(_configs()[0])
    j.load_session(p)
    assert j.map_stats() == saved
    with np.load(p + ".npz") as data:
        _assert_ms_equal_arrays(
            {f: np.asarray(getattr(j.ms, f)) for f in j.ms._fields},
            {f: data[f"ms.{f}"] for f in M.MapState._fields})
    small = SlamSystem(dataclasses.replace(tcfg, m_max=2048), "cpu")
    with pytest.raises(ValueError, match="capacities"):
        small.load_session(p)


def test_local_ba_every_kf_false(sequence):
    frames, gt, _ = sequence
    jcfg, tcfg = _configs(local_ba_every_kf=False)
    j, t = JSlam(jcfg), SlamSystem(tcfg, "cpu")
    pj, sj = _drive(j, frames[:N_SAVE])
    pt, st = _drive(t, frames[:N_SAVE])
    assert sj == st == ["OK"] * N_SAVE
    mj, mt = j.map_stats(), t.map_stats()
    assert abs(mj["n_kfs"] - mt["n_kfs"]) <= 1 and mt["n_kfs"] >= 2, (mj, mt)
    assert "LBA" not in t.timers.samples
    _close(pj, pt, _bound(j.trajectory, gt))


def _npz_arrays(path):
    with np.load(path + ".npz") as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        return {k: data[k] for k in data.files if k != "__meta__"}, meta


def test_cross_package_inertial_loop_session(sequence, tmp_path):
    frames, gt, imu = sequence
    orb = C.OrbConfig(n_features=400, n_levels=4, height=H, width=W)
    desc = []
    for i in (0, 15, 29):
        fs = extract(torch.from_numpy(frames[i][1]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    jvoc = JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)
    jcfg, tcfg = _configs(imu=IMU, loop=LOOP)
    a = JSlam(jcfg, vocab=jvoc)
    _drive_inertial(a, frames[:N_SAVE], imu, 0)
    assert a.imu.initialized and a.map_stats()["state"] == "OK"
    pj, pt = str(tmp_path / "jax_session"), str(tmp_path / "port_session")
    a.save_session(pj)
    port = SlamSystem(tcfg, "cpu", vocab=convert.vocabulary(jvoc, "cpu"))
    port.load_session(pj)
    port.save_session(pt)
    (aj, mj), (at, mt) = _npz_arrays(pj), _npz_arrays(pt)
    assert aj.keys() == at.keys(), sorted(set(aj) ^ set(at))
    for prefix in ("imu.bias", "imu.body.", "imu.preint.", "imu.chunk.",
                   "loop.bow", "loop.valid", "loop.groups", "loop.counts"):
        assert any(k.startswith(prefix) for k in aj), prefix
    for k in aj:
        assert aj[k].dtype == at[k].dtype and aj[k].shape == at[k].shape, k
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
    assert int(aj["loop.valid"].sum()) == a.map_stats()["n_kfs"] >= 4
    for part in ("imu", "loop", "sys", "vocab_checksum"):
        assert mt[part] == mj[part], part
    b = JSlam(jcfg, vocab=jvoc)
    b.load_session(pt)
    assert b.map_stats() == port.map_stats() == a.map_stats()
    cont = slice(N_SAVE, N_SAVE + N_CONT)
    pb, sb = _drive_inertial(b, frames[cont], imu, N_SAVE)
    pp, sp = _drive_inertial(port, frames[cont], imu, N_SAVE)
    assert sb == sp == ["OK"] * N_CONT, (sb, sp)
    cb, cp = b.map_stats(), port.map_stats()
    assert abs(cb["n_kfs"] - cp["n_kfs"]) <= 1, (cb, cp)
    _close(pb, pp, _bound(list(b.trajectory), gt))
