"""The port's fused frame step (geoflowslam_tpu_torch/pipeline/fused.py)
against the JAX package's (geoflowslam_tpu/pipeline/fused.py::frame_step),
on the CPU, from the same state.

A JAX SlamSystem (320x240, 300 features, 4 levels, 64 reserved OF slots, a
vocabulary, pkt_max_pending=0) tracks the synthetic room, loses it on blank
frames and revisits it; every frame_step call it makes is recorded with its
inputs and its outputs. A variant replays one call, or calls the JAX step
directly on a recorded state with other options, and runs the port's step
on the same state carried across with geoflowslam_tpu_torch/convert.py:

* tier-1: `off` (a tracked visual frame), `kf` (VI against a KF-anchored
  body state built at the recorded pose, IMU samples consistent with the
  motion model), `of_icp` (the dual-stream OF and the GICP predictor
  against the previous frame), `recovery` (the first revisit frame after
  the blank ones: the 40 px re-search and the relocalization in the step,
  both packages handed the same PnP draws);
* slow tier: `raw` (IMU samples, no initialized IMU), `prior` (the joint
  VI refinement under the `kf` variant's marginal), `lidar` (the point-to-
  plane refine against a local map of the previous frames' clouds), and
  `off` at EuRoC's 752x480 stereo shape.

What is held, each tolerance stated: the packet's four counts equal, or
within 1% where a near-tie flips (a keypoint whose descriptor distance
ties at a gate, from float32 rounding differences in the two packages'
image pipelines); the pose, twc and trel within 1e-4 m and 1e-4 rad;
`obs_mp` equal on >= 99% of keypoints; the bias and the marginal within
1e-4 of their largest entry; the aux flag equal. The same calls run under
a dispatch audit that counts the operations which synchronise with the
host on CUDA (scalar reads, `nonzero`, boolean masks, `eigh`/`svd`,
tensors built from host data): none in a variant without recovery, one in
the recovery variant.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from geoflowslam_tpu.imu import preintegration as JPRE
from geoflowslam_tpu.io.synthetic import (Camera, SyntheticSequence,
                                          SyntheticWorld)
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline import fused as JFU
from geoflowslam_tpu.pipeline import lidar_mapping as JLD
from geoflowslam_tpu.pipeline.inertial import InertialTracker as JTracker
from geoflowslam_tpu.pipeline.system import ImuConfig as JImu
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.solvers import inertial as JVI
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.ops.extractor import extract
from geoflowslam_tpu_torch.pipeline import fused as TFU
from geoflowslam_tpu_torch.pipeline import reloc as TR
from tests.test_torch_fused_recovery import _j_sample_sets

torch.set_num_threads(2)

W, H, FX, FPS = 320, 240, 200.0, 10.0
N_SLOTS = 64
N_A, N_BLANK, N_RE = 22, 4, 3
CPU = "cpu"


def _configs(w=W, h=H, fx=FX):
    orb = dict(n_features=300, n_levels=4, height=h, width=w)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              n_of_slots=N_SLOTS)
    sc = dict(fx=fx, fy=fx, cx=w / 2, cy=h / 2, bf=20.0, k_max=32,
              m_max=4096, kf_min_interval=1, kf_max_interval=2,
              time_recently_lost=30.0)
    return (JSys(frame=JFrame(orb=JOrb(**orb), **fc), pkt_max_pending=0,
                 **sc),
            C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                           **sc))


def _frame(seq, t):
    g, d, _ = seq.frame(t)
    return np.array(g), np.array(d)


def _vocab(seq, w, h):
    """The vocabulary (k = 8, 2 levels) JAX builds from three frames; the
    port's extractor gives the descriptors (bit-equal to JAX's)."""
    orb = C.OrbConfig(n_features=300, n_levels=4, height=h, width=w)
    desc = []
    for t in (0.0, 0.7, 1.4):
        fs = extract(torch.from_numpy(_frame(seq, t)[0]), orb)
        desc.append(fs.desc[fs.valid].numpy().view(np.uint32))
    return JV.build_vocabulary(np.concatenate(desc), k=8, levels=2, iters=3)


def _record(slam_fn):
    """Run slam_fn() with JAX's frame_step wrapped: returns the calls, each
    (args, kwargs, output)."""
    calls = []
    orig = JFU.frame_step

    def rec(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out
    JFU.frame_step = rec
    try:
        slam_fn()
    finally:
        JFU.frame_step = orig
    return calls


def _drive(w=W, h=H, fx=FX, n_a=N_A, blank=True):
    cam = Camera(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=FPS)
    jcfg, tcfg = _configs(w, h, fx)
    jvoc = _vocab(seq, w, h) if blank else None
    slam = JSlam(jcfg, vocab=jvoc)
    tags = []

    def run():
        for i in range(n_a):
            tags.append("track")
            slam.track_rgbd(*_frame(seq, i / FPS), i / FPS)
        if not blank:
            return
        gray = np.full((h, w), 100.0, np.float32)
        depth = np.full((h, w), 2.0, np.float32)
        for i in range(N_BLANK):
            tags.append("blank")
            slam.track_rgbd(gray, depth, 2.2 + i / FPS)
        for i in range(N_RE):
            tags.append("revisit")
            slam.track_rgbd(*_frame(seq, (4 + i) / FPS), 3.2 + i / FPS)
    calls = _record(run)
    # the initialization frame makes no call
    by_tag = {}
    for tag, call in zip(tags[len(tags) - len(calls):], calls):
        by_tag.setdefault(tag, []).append(call)
    return dict(seq=seq, jcfg=jcfg, tcfg=tcfg, jvoc=jvoc, slam=slam,
                calls=by_tag)


@pytest.fixture(scope="module")
def run():
    out = _drive()
    assert out["slam"].state.name == "OK"
    return out


# -- carrying a recorded call across ------------------------------------------

ARGS = ("gray", "depth", "ms", "last_obs_mp", "last_levels", "vel_rot",
        "vel_t", "use_vel", "cur_rot", "cur_t", "ref_kf", "local_masks",
        "acc", "gyro", "dts", "body", "bias", "prior_info", "r_cb", "t_cb",
        "calib", "cfg", "fcfg", "imu_mode", "min_inliers")


def _named(args, kwargs):
    d = dict(zip(ARGS, args))
    d.update(kwargs)
    return d


def _port_args(j, tcfg, p_frame=None):
    """The port's frame_step arguments for the JAX call j (a dict)."""
    c = lambda x: None if x is None else convert.to_tensor(x, CPU)  # noqa
    mode = j["imu_mode"]
    kf_modes = mode in ("kf", "prior")
    lf = j.get("last_frame")
    kw = dict(
        device=CPU,
        last_frame=None if lf is None else convert.frame_data(lf, CPU),
        use_of=j.get("use_of", False), use_icp=j.get("use_icp", False),
        icp_method=j.get("icp_method", "gicp"),
        icp_min_inliers=j.get("icp_min_inliers", 200),
        n_of_slots=j.get("n_of_slots", 0),
        use_lidar=j.get("use_lidar", False),
        lidar_map=(None if j.get("lidar_map") is None
                   else convert.local_map(j["lidar_map"], CPU)),
        lidar_cfg=C.LidarConfig() if j.get("use_lidar") else None)
    return (
        (c(j["gray"]), c(j["depth"]), convert.map_state(j["ms"], CPU),
         c(j["last_obs_mp"]), c(j["last_levels"]), c(j["vel_rot"]),
         c(j["vel_t"]), bool(j["use_vel"]), c(j["cur_rot"]), c(j["cur_t"]),
         int(j["ref_kf"]), convert.local_masks(j["local_masks"], CPU),
         p_frame, convert.body_state(j["body"], CPU) if kf_modes else None,
         c(j["bias"]).float() if kf_modes else None,
         c(j["prior_info"]) if mode == "prior" else None,
         c(j["r_cb"]) if kf_modes else None,
         c(j["t_cb"]) if kf_modes else None,
         tcfg.track_cfg(), tcfg.frame, mode, int(j["min_inliers"])), kw)


def _of_gumbel(seq_no, n_kp):
    """The OF stage's F-RANSAC noise of the JAX step: both streams' gumbel
    draws from the key the step derives from the packet sequence."""
    key = jax.random.PRNGKey(jnp.asarray(seq_no).astype(jnp.int32))
    k1, k2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.gumbel(k, (64, n_kp))))
                 for k in (k1, k2))


# -- the sync audit -----------------------------------------------------------

_SYNC_ATEN = {"_local_scalar_dense", "nonzero", "unique", "_unique",
              "_unique2", "unique_dim", "unique_consecutive", "masked_select",
              "_linalg_eigh", "linalg_eigh", "linalg_eigvalsh",
              "_linalg_svd", "linalg_inv", "linalg_solve", "linalg_cholesky",
              "repeat_interleave", "bincount", "histc", "lift_fresh",
              "lift_fresh_copy", "equal", "is_nonzero", "masked_scatter"}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__", "tensor", "as_tensor"}


class _Audit(TorchDispatchMode):
    """Counts the operations that synchronise with the host on CUDA."""

    def __init__(self, hits):
        super().__init__()
        self.hits = hits

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if name in _SYNC_ATEN:
            self.hits.append(name)
        if name in ("index", "index_put", "index_put_"):
            if any(i is not None and i.dtype == torch.bool for i in args[1]):
                self.hits.append(name + " (bool mask)")
        return func(*args, **(kwargs or {}))


class _AuditPy(TorchFunctionMode):
    def __init__(self, hits):
        super().__init__()
        self.hits = hits

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _SYNC_METHODS:
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


def _port_step(args, kw):
    """The port's frame_step on (args, kw) under the audit: (out, hits).
    A first run, not audited, fills the per-device constant caches (the
    Jacobi schedules, gravity), as the card's warm-up does."""
    TFU.frame_step(*args, **kw)
    hits = []
    with _AuditPy(hits), _Audit(hits):
        out = TFU.frame_step(*args, **kw)
    return out, hits


# -- the comparison -----------------------------------------------------------

def _rot_err(a, b) -> float:
    """The angle between two rotations from ||A - B||_F = 2 sqrt(2)
    sin(theta / 2) (arccos of the trace loses ~3e-4 rad to float32
    rounding near theta = 0)."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _hold(jout, tout, variant):
    jp, tp = np.asarray(jout.host_pkt), tout.host_pkt.numpy()
    assert tp.shape == (TFU.PKT_LEN,) and jp.shape == (35,)
    for k, name in enumerate(("n_mm", "n_lm", "n_vi", "vi_accepted")):
        a, b = int(tp[k]), int(jp[k])
        # equal, or within 1% where a near-tie flips (see the module doc)
        assert abs(a - b) <= 0.01 * abs(b), (variant, name, a, b)
    for name, (ta, ja) in (("pose", (torch.cat([tout.rot, tout.t[:, None]],
                                                1), np.concatenate(
        [np.asarray(jout.rot), np.asarray(jout.t)[:, None]], 1))),
                           ("twc", (tout.twc, jout.twc)),
                           ("trel", (tout.trel, jout.trel))):
        ta, ja = ta.numpy(), np.asarray(ja)
        assert np.abs(ta[:, 3] - ja[:, 3]).max() <= 1e-4, (variant, name)
        assert _rot_err(ta[:, :3], ja[:, :3]) <= 1e-4, (variant, name)
    same = (tout.obs_mp.numpy() == np.asarray(jout.obs_mp)).mean()
    assert same >= 0.99, (variant, same)
    scale = max(np.abs(jp[28:34]).max(), 1e-12)
    assert np.abs(tp[28:34] - jp[28:34]).max() <= 1e-4 * scale, variant
    if jout.marg is not None:
        jm = np.asarray(jout.marg)
        assert (np.abs(tout.marg.numpy() - jm).max()
                <= 1e-4 * np.abs(jm).max()), variant
    assert tp[TFU.PKT_AUX] == jp[34], (variant, tp[TFU.PKT_AUX], jp[34])


# -- the variants -------------------------------------------------------------

def _replay(run, tag, k):
    args, kwargs, jout = run["calls"][tag][k]
    return _named(args, kwargs), jout


def _jax_direct(j, **over):
    """JAX's frame_step on a recorded call's state with options replaced."""
    d = dict(j)
    d.update(over)
    args = [d.pop(n) for n in ARGS]
    return JFU.frame_step(*args, **d)


def _imu_inputs(j, seed=0):
    """A body state at the recorded pose whose velocity, and IMU samples
    whose rates, carry the motion model's prediction over the frame gap
    (identity camera-body extrinsics, gravity -z of the map frame, no
    bias): (acc [32, 3], gyro [32, 3], dts [32], JAX BodyState)."""
    rng = np.random.default_rng(seed)
    cur_r = np.asarray(j["cur_rot"], np.float64)
    cur_t = np.asarray(j["cur_t"], np.float64)
    pr, pt = JL.se3_compose(j["vel_rot"], j["vel_t"], j["cur_rot"],
                            j["cur_t"])
    pr, pt = np.asarray(pr, np.float64), np.asarray(pt, np.float64)
    r1, p1 = cur_r.T, -cur_r.T @ cur_t
    r2, p2 = pr.T, -pr.T @ pt
    dt = 1.0 / FPS
    n = int(round(dt * 200.0))
    dr = r1.T @ r2
    w = np.arccos(np.clip((np.trace(dr) - 1.0) / 2.0, -1.0, 1.0))
    axis = (np.array([dr[2, 1] - dr[1, 2], dr[0, 2] - dr[2, 0],
                      dr[1, 0] - dr[0, 1]]) / (2.0 * np.sin(w) + 1e-12))
    gyro = np.zeros((32, 3), np.float32)
    acc = np.zeros((32, 3), np.float32)
    dts = np.zeros(32, np.float32)
    gyro[:n] = axis * w / dt + 1e-3 * rng.standard_normal((n, 3))
    acc[:n] = r1.T @ np.array([0.0, 0.0, 9.81]) \
        + 1e-2 * rng.standard_normal((n, 3))
    dts[:n] = dt / n
    z3 = jnp.zeros(3)
    body = JVI.BodyState(r_wb=jnp.asarray(r1, jnp.float32),
                         p=jnp.asarray(p1, jnp.float32),
                         v=jnp.asarray((p2 - p1) / dt, jnp.float32),
                         bg=z3, ba=z3)
    return acc, gyro, dts, body


def _imu_call(j, mode, prior=None):
    """JAX's step on the recorded state in an IMU mode; the port's Preint
    carried across from the JAX preintegration of the same samples."""
    imu = JTracker(JImu())
    acc, gyro, dts, body = _imu_inputs(j)
    bias = jnp.zeros(6)
    over = dict(acc=acc, gyro=gyro, dts=dts, body=body, bias=bias,
                prior_info=prior, r_cb=imu.r_cb, t_cb=imu.t_cb,
                calib=imu.calib, imu_mode=mode)
    jout = _jax_direct(j, **over)
    p = JPRE.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                          jnp.asarray(dts), bias, imu.calib)
    j2 = dict(j)
    j2.update(over)
    return j2, jout, convert.preintegrated(p, CPU)


def _check(run, variant, j, jout, p_frame=None, **extra):
    args, kw = _port_args(j, run["tcfg"], p_frame)
    kw.update(extra)
    tout, hits = _port_step(args, kw)
    _hold(jout, tout, variant)
    return tout, hits


def test_fused_step_off(run):
    j, jout = _replay(run, "track", -2)
    assert j["imu_mode"] == "off" and not j.get("with_recovery")
    _, hits = _check(run, "off", j, jout)
    assert hits == [], hits


def test_fused_step_kf(run):
    j, _ = _replay(run, "track", -2)
    j, jout, p = _imu_call(j, "kf")
    assert bool(np.asarray(jout.scalars)[3]), "VI not accepted"
    tout, hits = _check(run, "kf", j, jout, p)
    assert hits == [], hits


def test_fused_step_of_icp(run):
    j, _ = _replay(run, "track", -2)
    _, _, prev = run["calls"]["track"][-3]
    over = dict(last_frame=prev.frame, use_of=True, use_icp=True,
                n_of_slots=N_SLOTS)
    jout = _jax_direct(j, **over)
    j.update(over)
    n3d, n2d = (int(x) for x in np.asarray(jout.of_counts))
    assert n3d + n2d > 0
    tout, hits = _check(run, "of_icp", j, jout, of_gumbel=_of_gumbel(
        j["seq"], int(np.asarray(prev.frame.feat.valid).shape[0])))
    assert [int(x) for x in tout.of_counts] == [n3d, n2d]
    assert hits == [], hits


def test_fused_step_recovery(run):
    """The first revisit frame after the blank ones: the step recovers it
    (aux = 2 + the matched KF) with the reference's choice of stage."""
    j, jout = _replay(run, "revisit", 0)
    assert j["with_recovery"]
    aux = float(np.asarray(jout.host_pkt)[34])
    assert aux >= 2.0, aux
    jvoc = run["jvoc"]
    tcfg = run["tcfg"]
    key = jax.random.PRNGKey(
        jnp.asarray(j["seq"]).astype(jnp.int32) + 7777)
    sets = _j_sample_sets(jvoc, j["reloc_db"], j["ms"], jout.frame, key)
    tvoc = convert.vocabulary(jvoc, CPU)
    tdb, tms = convert.kf_database(j["reloc_db"], CPU), \
        convert.map_state(j["ms"], CPU)

    def relocalize(f):
        return TR.reloc_core(tvoc, tdb, tms, f, None, tcfg.track_cfg(), W,
                             H, sample_sets=sets)
    tout, hits = _check(run, "recovery", j, jout, with_recovery=True,
                        relocalize=relocalize)
    # the one host read, whether the frame's track failed: Python's bool()
    # and the scalar read it dispatches
    assert hits == ["__bool__", "_local_scalar_dense"], hits


@pytest.mark.slow
def test_fused_step_raw(run):
    j, _ = _replay(run, "track", -2)
    j, jout, p = _imu_call(j, "raw")
    _, hits = _check(run, "raw", j, jout, p)
    assert hits == [], hits


@pytest.mark.slow
def test_fused_step_prior(run):
    j0, _ = _replay(run, "track", -3)
    _, jk, _ = _imu_call(j0, "kf")
    j, _ = _replay(run, "track", -2)
    j, jout, p = _imu_call(j, "prior", prior=jk.marg)
    assert jout.marg is not None
    _, hits = _check(run, "prior", j, jout, p)
    assert hits == [], hits


@pytest.mark.slow
def test_fused_step_lidar(run):
    lcfg = JLD.LidarConfig()
    lm = JLD.create_local_map(lcfg)
    for k in (-5, -4, -3):
        _, _, o = run["calls"]["track"][k]
        lm = JLD.insert_kf_cloud(lm, o.frame.cloud, o.frame.cloud_valid,
                                 o.rot, o.t, 0, 0, lcfg)
    j, _ = _replay(run, "track", -2)
    over = dict(use_lidar=True, lidar_map=lm, lidar_cfg=lcfg)
    jout = _jax_direct(j, **over)
    j.update(over)
    _, hits = _check(run, "lidar", j, jout)
    assert hits == [], hits


@pytest.mark.slow
def test_fused_step_off_at_the_stereo_shape():
    """EuRoC's 752x480 (the stereo entry points' shape) on a short run."""
    out = _drive(752, 480, 458.654, n_a=6, blank=False)
    args, kwargs, jout = out["calls"]["track"][-1]
    j = _named(args, kwargs)
    tout, hits = _check(out, "off@752x480", j, jout)
    assert hits == [], hits


class _Pair(NamedTuple):
    same: torch.Tensor
    other: torch.Tensor


def test_tree_where_leaves_shared_fields_alone():
    """A field that is one tensor on both sides is passed through (not
    copied); the others are selected."""
    shared = torch.ones(3)
    a, b = _Pair(shared, torch.zeros(3)), _Pair(shared, torch.ones(3))
    out = TFU.tree_where(torch.tensor(False), a, b)
    assert out.same is shared
    assert torch.equal(out.other, torch.ones(3))
    out = TFU.tree_where(torch.tensor(True), a, b)
    assert torch.equal(out.other, torch.zeros(3))
