"""Atlas and session checkpoints (port of geoflowslam_tpu/state/serialize.py).

The files are the JAX package's own npz format, so a checkpoint written by
one package loads in the other: FORMAT_VERSION 1, the MapState fields as
`<field>` (atlas) or `ms.<field>` (session) in the JAX package's dtypes (the
descriptor words as uint32; the port holds them as int32 with the same
bits), the tracker under `sys.*`, the IMU under `imu.*`, the loop closer's
BoW database and consistency chains under `loop.*` (or a standalone reloc
database under `relocdb.*`), and a JSON `__meta__` with the same keys. The
vocabulary gate hashes the same bytes as the JAX package's
(`_vocab_checksum`: the 32-bit centre words level by level, then the
float32 weights), so the default vocabulary has one digest in both.

Reading puts every array on the system's device in the dtype the port's
`map_state.create` gives that field. A restored session continues tracking
from the checkpointed frame. As in the JAX package, the transient state
restarts empty (the trajectory, the culled-KF links, the local window, the
previous frame of the OF and ICP stages, the KF clouds and EdgeICP
measurements), and the random generators are not checkpointed: the port's
`_gen`, `_reloc_gen`, `_init_gen` and the loop closer's generator are
re-seeded as their constructors seed them, so a restored session restarts
its draws (the JAX package does not save its init key either).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from geoflowslam_tpu_torch.state import map_state as M

FORMAT_VERSION = 1

# fields the JAX package stores as uint32 (the port: int32, the same bits)
_WORDS = ("kf_desc", "mp_desc")
_dtypes: dict = {}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _field_dtypes() -> dict:
    """The port's dtype of each MapState field (as map_state.create)."""
    if not _dtypes:
        ms = M.create(1, 1, 1, "cpu")
        _dtypes.update({f: getattr(ms, f).dtype for f in M.MapState._fields})
    return _dtypes


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """Host array -> tensor on `device`; uint32 words become int32 with the
    same bits, then `dtype` when given."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def ms_to_host(ms: M.MapState) -> dict:
    """field -> numpy array in the JAX package's dtype."""
    out = {}
    for f in ms._fields:
        a = _host(getattr(ms, f))
        out[f] = a.view(np.uint32) if f in _WORDS else a
    return out


def ms_from_host(arrays: dict, device) -> M.MapState:
    dt = _field_dtypes()
    return M.MapState(**{f: _tensor(arrays[f], device, dt[f])
                         for f in M.MapState._fields})


def _vocab_checksum(vocab) -> str:
    """MD5 over the vocabulary tree (CalculateCheckSum analogue), over the
    bytes the JAX package hashes."""
    if vocab is None:
        return "none"
    h = hashlib.md5()
    for lvl in vocab.centers:
        h.update(np.ascontiguousarray(_host(lvl)).tobytes())
    h.update(np.ascontiguousarray(_host(vocab.weights), np.float32)
             .tobytes())
    return h.hexdigest()


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _read(path: str, kind: str):
    data = np.load(_npz(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"{kind} format {meta['format_version']} != "
                         f"{FORMAT_VERSION}")
    return data, meta


def save_atlas(path: str, ms: M.MapState, vocab=None,
               extra: Optional[dict] = None):
    """Write <path>.npz with all MapState fields + metadata."""
    arrays = ms_to_host(ms)
    meta = {
        "format_version": FORMAT_VERSION,
        "vocab_checksum": _vocab_checksum(vocab),
        "fields": list(ms._fields),
        "extra": extra or {},
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, vocab=None, check_vocab: bool = True, *,
               device) -> Tuple[M.MapState, dict]:
    """Load a MapState onto `device`; verifies the vocabulary checksum like
    LoadAtlas."""
    data, meta = _read(path, "atlas")
    if check_vocab and vocab is not None:
        cs = _vocab_checksum(vocab)
        if cs != meta["vocab_checksum"]:
            raise ValueError(
                "vocabulary checksum mismatch (the reference refuses to load "
                f"an atlas built with a different vocabulary): {cs} != "
                f"{meta['vocab_checksum']}")
    ms = ms_from_host({f: data[f] for f in meta["fields"]}, device)
    return ms, meta.get("extra", {})


# -- full-session checkpoints -----------------------------------------------


def save_session(path: str, slam) -> None:
    """Checkpoint a SlamSystem mid-run so `load_session` can continue it:
    the MapState, the tracking state (pose, motion model, bindings, the last
    frame's keypoint octaves, the VI prior), the IMU tracker (bias, body
    state, per-KF preintegration segments, the raw samples since the last
    KF, the initialization flags), the loop closer's BoW database and
    consistency chains (or the standalone reloc database), and the host
    bookkeeping. The KF parents (`kf_prev` in the meta) come from the map's
    own `kf_prev` of the valid slots."""
    arrays = {f"ms.{f}": a for f, a in ms_to_host(slam.ms).items()}

    def put(key, val):
        if val is not None:
            arrays[key] = _host(val)

    put("sys.cur_rot", slam.cur_rot)
    put("sys.cur_t", slam.cur_t)
    put("sys.vel_rot", slam.vel[0])
    put("sys.vel_t", slam.vel[1])
    put("sys.last_obs_mp", slam.last_obs_mp)
    put("sys.last_levels", slam.last_levels)
    put("sys.vi_prior", slam._vi_prior)

    imu = slam.imu
    imu_meta = None
    if imu is not None:
        put("imu.bias", imu.bias)
        if imu.body is not None:
            for f in imu.body._fields:
                put(f"imu.body.{f}", getattr(imu.body, f))
        for slot, p in imu.kf_preints.items():
            for f in p._fields:
                put(f"imu.preint.{slot}.{f}", getattr(p, f))
        # the raw samples since the last KF, so that the next KF's segment
        # stays exact across the checkpoint
        for i, (acc, gyro, dts, _) in enumerate(imu._chunks):
            put(f"imu.chunk.{i}.acc", acc)
            put(f"imu.chunk.{i}.gyro", gyro)
            put(f"imu.chunk.{i}.dts", dts)
        imu_meta = {
            "initialized": imu.initialized,
            "init_time": imu.init_time,
            "viba1_done": imu.viba1_done,
            "viba2_done": imu.viba2_done,
            "kf_order": [int(k) for k in imu.kf_order],
            "preint_fields": (list(next(iter(imu.kf_preints.values()))
                                   ._fields) if imu.kf_preints else []),
            "chunk_ts": [None if c[3] is None else float(c[3])
                         for c in imu._chunks],
            "has_body": imu.body is not None,
        }

    lc = slam.loop_closer
    if lc is not None:
        put("loop.bow", lc.db.bow)
        put("loop.valid", lc.db.valid)
        put("loop.groups", lc._groups)
        put("loop.counts", lc._counts)
    elif slam._reloc_db is not None:
        put("relocdb.bow", slam._reloc_db.bow)
        put("relocdb.valid", slam._reloc_db.valid)

    kf_valid = _host(slam.ms.kf_valid)
    kf_prev = _host(slam.ms.kf_prev)
    meta = {
        "format_version": FORMAT_VERSION,
        "vocab_checksum": _vocab_checksum(slam.vocab),
        "ms_fields": list(slam.ms._fields),
        "sys": {
            "state": slam.state.name,
            "has_vel": bool(slam.has_vel),
            "ref_kf": int(slam.ref_kf),
            "ref_kf_inliers": int(slam.ref_kf_inliers),
            "frames_since_kf": int(slam.frames_since_kf),
            "last_time": float(slam.last_time),
            "time_base": slam.time_base,
            "lost_since": slam.lost_since,
            "n_frames": int(slam.n_frames),
            "n_lost": int(slam.n_lost),
            "last_kf_time": float(slam._last_kf_time),
            "gen_counter": int(slam._gen_counter),
            "kf_gen": {str(k): int(v) for k, v in slam._kf_gen.items()},
            "kf_prev": {str(k): int(kf_prev[k])
                        for k in np.flatnonzero(kf_valid)},
            "last_kf_slot": slam._last_kf_slot,
        },
        "imu": imu_meta,
        "loop": ({"n_loops": int(lc.n_loops), "n_merges": int(lc.n_merges)}
                 if lc is not None else None),
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", _npz(path))


def load_session(path: str, slam) -> dict:
    """Restore a `save_session` checkpoint (of either package) into an
    existing SlamSystem, whose SystemConfig must have the saved capacities,
    onto its device, and continue tracking from the checkpointed frame.
    Returns the session meta dict. A running asynchronous global BA of
    `slam` is dropped (it belongs to the map the checkpoint replaces)."""
    from geoflowslam_tpu_torch.imu import preintegration as pre
    from geoflowslam_tpu_torch.pipeline import lidar_mapping as LD
    from geoflowslam_tpu_torch.pipeline.system import TrackingState
    from geoflowslam_tpu_torch.retrieval.kf_database import KFDatabase
    from geoflowslam_tpu_torch.solvers.inertial import BodyState

    data, meta = _read(path, "session")
    if slam.vocab is not None:
        cs = _vocab_checksum(slam.vocab)
        if cs != meta["vocab_checksum"]:
            raise ValueError(f"vocabulary checksum mismatch: {cs} != "
                             f"{meta['vocab_checksum']}")
    dev = slam.device
    ms = ms_from_host({f: data[f"ms.{f}"] for f in meta["ms_fields"]}, dev)
    if ms.k_max != slam.cfg.k_max or ms.m_max != slam.cfg.m_max:
        raise ValueError("session capacities do not match SystemConfig")

    def opt(key, dtype=None):
        return _tensor(data[key], dev, dtype) if key in data else None

    f32 = torch.float32
    s = meta["sys"]
    slam.ms = ms
    slam.state = TrackingState[s["state"]]
    slam.cur_rot = opt("sys.cur_rot", f32)
    slam.cur_t = opt("sys.cur_t", f32)
    slam.vel = (opt("sys.vel_rot", f32), opt("sys.vel_t", f32))
    slam.has_vel = bool(s["has_vel"])
    slam.last_obs_mp = opt("sys.last_obs_mp", torch.int32)
    slam.last_levels = opt("sys.last_levels", torch.int32)
    slam._vi_prior = opt("sys.vi_prior", f32)
    slam.ref_kf = int(s["ref_kf"])
    slam.ref_kf_inliers = int(s["ref_kf_inliers"])
    slam.frames_since_kf = int(s["frames_since_kf"])
    slam.last_time = float(s["last_time"])
    slam.time_base = s["time_base"]
    slam.lost_since = s["lost_since"]
    slam.n_frames = int(s["n_frames"])
    slam.n_lost = int(s["n_lost"])
    slam._last_kf_time = float(s["last_kf_time"])
    slam._gen_counter = int(s["gen_counter"])
    slam._kf_gen = {int(k): int(v) for k, v in s["kf_gen"].items()}
    slam._kf_prev_h = {int(k): int(v) for k, v in s["kf_prev"].items()}
    slam._last_kf_slot = s.get("last_kf_slot")
    # the transient state restarts empty
    slam._traj = []
    slam._lost_stamps = set()
    slam._culled_rel = {}
    slam._deferred = []
    slam._mirror_dirty = True
    slam.local_masks = None
    slam.last_frame = None
    slam._kf_clouds.clear()
    slam._kf_icp_rel.clear()
    slam._pending_init_frame = None
    slam._carried_streak = 0
    if slam.lidar_map is not None:
        slam.lidar_map = LD.create_local_map(slam._lidar_cfg, dev)
    if slam._gba is not None:
        slam._gba.abort()
    slam._reseed_generators()

    im = meta.get("imu")
    if im is not None and slam.imu is not None:
        imu = slam.imu
        imu.bias = np.asarray(data["imu.bias"], np.float32)
        imu.body = None
        if im["has_body"]:
            imu.body = BodyState(**{f: opt(f"imu.body.{f}", f32)
                                    for f in BodyState._fields})
        imu.initialized = bool(im["initialized"])
        imu.init_time = im["init_time"]
        imu.viba1_done = bool(im["viba1_done"])
        imu.viba2_done = bool(im["viba2_done"])
        imu.last_transform = None
        imu.kf_order = [int(k) for k in im["kf_order"]]
        imu.kf_preints = {}
        for slot in imu.kf_order:
            if f"imu.preint.{slot}.dt" in data:
                imu.kf_preints[slot] = pre.Preintegrated(**{
                    f: np.asarray(data[f"imu.preint.{slot}.{f}"])
                    for f in im["preint_fields"]})
        imu._chunks = [(np.asarray(data[f"imu.chunk.{i}.acc"]),
                        np.asarray(data[f"imu.chunk.{i}.gyro"]),
                        np.asarray(data[f"imu.chunk.{i}.dts"]), ts)
                       for i, ts in enumerate(im["chunk_ts"])]

    lo = meta.get("loop")
    if lo is not None and slam.loop_closer is not None:
        lc = slam.loop_closer
        lc.db = KFDatabase(bow=opt("loop.bow", f32),
                           valid=opt("loop.valid", torch.bool))
        lc._groups = opt("loop.groups", torch.bool)
        lc._counts = opt("loop.counts", torch.int32)
        lc.n_loops = int(lo["n_loops"])
        lc.n_merges = int(lo["n_merges"])
    if "relocdb.bow" in data and slam._reloc_db is not None:
        slam._reloc_db = KFDatabase(bow=opt("relocdb.bow", f32),
                                    valid=opt("relocdb.valid", torch.bool))
    return meta
