"""Port parity of the tracking and mapping stages, on a map the JAX package
built: pose-only GN, then motion-model tracking, local-map tracking and one
mapping_step on the 13th frame of the test_e2e_rgbd scenario, each stage fed
the same inputs on both sides.

Tolerances: pose_opt pose within 1e-4 with an equal inlier mask; each
tracking stage's inlier count within +-2 and its pose within 1 mm / 0.05
deg; after mapping_step every keyframe pose within 1 mm and the valid
map-point count within 2%."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.pipeline import local_mapping as JLM
from geoflowslam_tpu.pipeline import tracking as JT
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.solvers import pose_opt as JPO
from geoflowslam_tpu.state import map_state as JM
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.pipeline import tracking as TT
from geoflowslam_tpu_torch.solvers import pose_opt as TPO
from geoflowslam_tpu_torch.state import map_state as TM
from test_torch_shared import shared_result

torch.set_num_threads(2)

W, H, FX = 320, 240, 200.0
N_BUILD = 12          # frames in the JAX-built map
KF_EVERY = 3
CPU = torch.device("cpu")


def _configs():
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0, k_max=24, m_max=4096)
    jcfg = JSys(frame=JFrame(orb=JOrb(**orb), **fc), **sc)
    tcfg = C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                          **sc)
    return jcfg, tcfg


def _angle_deg(ra, rb):
    c = (np.trace(np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T)
         - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _assert_pose_close(rj, tj, rt, tt, trans=1e-3, rot_deg=0.05):
    assert np.linalg.norm(np.asarray(tj) - tt.numpy()) < trans
    assert _angle_deg(rj, rt.numpy()) < rot_deg


def _jax_mapping_step(ms, frame, rot, t, time_rel, obs, ref, slot, jcfg):
    kw = 8
    return JLM.mapping_step(
        ms, frame, rot, t, jnp.float32(time_rel), obs, jnp.int32(ref),
        jnp.int32(slot), np.zeros(3, np.float32), np.zeros(6, np.float32),
        np.zeros((kw,), np.int32), np.zeros((kw,), bool), None, None, None,
        None, None, jcfg.track_cfg(), jcfg.map_cfg(), kw, False)


def build_map():
    """The JAX package's map after N_BUILD frames (staged loop: init, motion
    model, local map, a KF every KF_EVERY frames), and the next frame, built
    and as its gray and depth images."""
    jcfg, tcfg = _configs()
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=10.0)
    jtc = jcfg.track_cfg()
    jbf = jax.jit(lambda g, d: j_build_frame(g, d, jcfg.frame, FX, FX,
                                             W / 2, H / 2))
    lw = jax.jit(lambda ms, ref: JM.local_window(ms, ref, jtc.local_window,
                                                 jtc.lm_max_candidates))
    images = [seq.frame(i / 10.0)[:2] for i in range(N_BUILD + 1)]
    frames = [jbf(*im) for im in images]
    ms = JM.create(jcfg.k_max, 400, jcfg.m_max)
    ms, slot, res = JT.stereo_initialization(ms, frames[0], jnp.float32(0.0),
                                             jtc)
    ref = int(slot)
    cur = (res.rot, res.t)
    vel = (jnp.eye(3), jnp.zeros(3))
    last_obs, masks = res.obs_mp, None
    for i in range(1, N_BUILD):
        f = frames[i]
        pr, pt = JL.se3_compose(vel[0], vel[1], *cur)
        r1 = JT.track_with_motion_model(ms, f, last_obs, pr, pt, jtc,
                                        last_levels=frames[i - 1].feat.level)
        if masks is None:
            masks = lw(ms, jnp.int32(ref))
        ms, r2 = JT.track_local_map(ms, f, r1.obs_mp, r1.rot, r1.t,
                                    jnp.int32(ref), jtc, local_masks=masks)
        assert int(r2.n_inliers) >= 50
        li = JL.se3_inverse(*cur)
        vel = JL.se3_compose(r2.rot, r2.t, *li)
        cur, last_obs = (r2.rot, r2.t), r2.obs_mp
        if i % KF_EVERY == 0:
            new = int(np.argmin(np.asarray(ms.kf_valid)))
            ms, last_obs, masks, kr, kt, _ = _jax_mapping_step(
                ms, f, r2.rot, r2.t, i / 10.0, r2.obs_mp, ref, new, jcfg)
            cur, ref = (kr, kt), new
    pr, pt = JL.se3_compose(vel[0], vel[1], *cur)
    return dict(jcfg=jcfg, tcfg=tcfg, ms=ms, frame=frames[N_BUILD],
                last_levels=frames[N_BUILD - 1].feat.level, last_obs=last_obs,
                pred=(pr, pt), ref=ref, masks=masks,
                gray=images[N_BUILD][0], depth=images[N_BUILD][1])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """build_map's result (numpy arrays), once per session for every xdist
    worker (tests/test_torch_shared.py); test_torch_fused_track.py shares
    it."""
    return shared_result(tmp_path_factory, "tracking_built", build_map)


def test_pose_optimization():
    """Same observations (5% outliers, stereo and mono rows): pose within
    1e-4 and an equal inlier mask."""
    rs = np.random.RandomState(4)
    n = 300
    pts = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n),
                    rs.uniform(2, 6, n)], 1).astype(np.float32)
    r_true = np.asarray(JL.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    t_true = np.array([0.05, -0.02, 0.1], np.float32)
    pc = pts @ r_true.T + t_true
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + 160, FX * pc[:, 1] / pc[:, 2]
                   + 120], 1) + rs.randn(n, 2) * 0.5
    uv[:15] += rs.randn(15, 2) * 40
    ur = uv[:, 0] - 20.0 / pc[:, 2]
    stereo = rs.rand(n) > 0.3
    lvl = rs.randint(0, 4, n)
    args = dict(pts_w=pts, uv=uv.astype(np.float32),
                u_right=ur.astype(np.float32), is_stereo=stereo,
                inv_sigma2=(1.0 / 1.44 ** lvl).astype(np.float32),
                valid=rs.rand(n) > 0.05)
    r0 = np.eye(3, dtype=np.float32)
    t0 = np.zeros(3, np.float32)
    rj, tj, inl_j, nj = JPO.pose_optimization(
        jnp.asarray(r0), jnp.asarray(t0),
        JPO.PoseObs(**{k: jnp.asarray(v) for k, v in args.items()}),
        FX, FX, 160.0, 120.0, 20.0)
    rt, tt, inl_t, nt = TPO.pose_optimization(
        torch.from_numpy(r0), torch.from_numpy(t0),
        TPO.PoseObs(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in args.items()}),
        FX, FX, 160.0, 120.0, 20.0)
    np.testing.assert_allclose(np.asarray(rj), rt.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(tj), tt.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
    assert int(nj) == int(nt) > 250


def test_tracking_and_mapping_stages(built):
    b = built
    jtc = b["jcfg"].track_cfg()
    ttc = b["tcfg"].track_cfg()
    ms_t = convert.map_state(b["ms"], CPU)
    frame_t = convert.frame_data(b["frame"], CPU)
    T = lambda a: convert.to_tensor(a, CPU)
    pr, pt = b["pred"]

    # motion model
    rj = JT.track_with_motion_model(b["ms"], b["frame"], b["last_obs"], pr, pt,
                                    jtc, last_levels=b["last_levels"])
    rt = TT.track_with_motion_model(ms_t, frame_t, T(b["last_obs"]), T(pr),
                                    T(pt), ttc, T(b["last_levels"]))
    assert int(rj.n_inliers) >= 50
    assert abs(int(rj.n_inliers) - int(rt.n_inliers)) <= 2
    _assert_pose_close(rj.rot, rj.t, rt.rot, rt.t)

    # local map, both fed the reference's motion-model result and window
    masks_t = tuple(T(x) for x in b["masks"])
    masks_t = (masks_t[0], masks_t[1], masks_t[2].long())
    ms2_j, lj = JT.track_local_map(b["ms"], b["frame"], rj.obs_mp, rj.rot,
                                   rj.t, jnp.int32(b["ref"]), jtc,
                                   local_masks=b["masks"])
    ms2_t, lt = TT.track_local_map(ms_t, frame_t, T(rj.obs_mp), T(rj.rot),
                                   T(rj.t), ttc, masks_t)
    assert int(lj.n_inliers) > int(rj.n_inliers)
    assert abs(int(lj.n_inliers) - int(lt.n_inliers)) <= 2
    _assert_pose_close(lj.rot, lj.t, lt.rot, lt.t)
    np.testing.assert_allclose(np.asarray(ms2_j.mp_visible),
                               ms2_t.mp_visible.numpy(), atol=2.0)

    # one mapping_step on the reference's post-tracking state
    slot = int(np.argmin(np.asarray(ms2_j.kf_valid)))
    out_j = _jax_mapping_step(ms2_j, b["frame"], lj.rot, lj.t, 1.2, lj.obs_mp,
                              b["ref"], slot, b["jcfg"])
    out_t = TLM.mapping_step(convert.map_state(ms2_j, CPU), frame_t,
                             T(lj.rot), T(lj.t), 1.2, T(lj.obs_mp), b["ref"],
                             slot, ttc, b["tcfg"].map_cfg())
    msj, mst = out_j[0], out_t[0]
    valid = np.asarray(msj.kf_valid)
    np.testing.assert_array_equal(valid, mst.kf_valid.numpy())
    assert valid.sum() >= 4
    dt = np.abs(np.asarray(msj.kf_t)[valid] - mst.kf_t.numpy()[valid])
    assert dt.max() < 1e-3
    for k in np.where(valid)[0]:
        assert _angle_deg(np.asarray(msj.kf_rot)[k], mst.kf_rot.numpy()[k]) \
            < 0.05
    nj, nt = int(np.asarray(msj.mp_valid).sum()), int(mst.mp_valid.sum())
    assert abs(nj - nt) <= 0.02 * nj
    assert int(out_j[5][0]) == int(out_t[5])     # culled slot


def test_convert_atlas_and_track_result(built, tmp_path):
    """The npz of the reference's save_atlas loads into the port's MapState
    with every field equal (uint32 descriptor words as int32 bits)."""
    from geoflowslam_tpu.state.serialize import save_atlas
    from geoflowslam_tpu_torch.state import serialize as TSER
    path = str(tmp_path / "atlas")
    save_atlas(path, built["ms"])
    ms_t, extra = TSER.load_atlas(path, check_vocab=False, device=CPU)
    assert extra == {}
    for name in TM.MapState._fields:
        ref = np.asarray(getattr(built["ms"], name))
        got = getattr(ms_t, name).numpy()
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        np.testing.assert_array_equal(ref, got, err_msg=name)
    res = JT.TrackResult(*(np.asarray(x) for x in (
        built["pred"][0], built["pred"][1], built["last_obs"], 7)))
    rt = convert.track_result(res, CPU)
    assert isinstance(rt, TT.TrackResult) and int(rt.n_inliers) == 7
    np.testing.assert_array_equal(rt.obs_mp.numpy(), np.asarray(built["last_obs"]))
