"""Port parity of the optical-flow stage: fundamental-matrix RANSAC
(ops/ransac.py) and the dual-stream optical flow
(pipeline/of_tracking.py::of_dual_stream).

jax.random's draws cannot be reproduced, so both sides get the same
randomness: `ransac_fundamental` the same minimal sets (`sample_sets`), and
`of_dual_stream` the same Gumbel noise the JAX stage draws from its key.
The stage runs on a map the JAX package initialized from frame 0 of the
synthetic room (320x240, 300 features, 256 OF slots) and on the frame 0.4 s
later, predicted at the true pose; every other map binding of frame 0 is
dropped, so that both streams have sources.

Tolerances: RANSAC inlier masks equal, score within 1e-4 relative and the
normalized F within 1e-3 (SVDs of the same 8x9 systems by two LAPACK
paths). of_dual_stream: the 3D- and 2D-stream counts within 2 each and
their map-point bindings within 2 (an LK status or an F-inlier on its gate
can flip under another sum order); slots that carry the same binding agree
within 1e-3 px, in depth within 1e-4 m and in descriptor; 2D-stream slots
find a reference slot within 1e-3 px for all but 2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.ops import ransac as JR
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline import of_tracking as JOF
from geoflowslam_tpu.pipeline import tracking as JT
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.state import map_state as JM
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.ops import ransac as TR
from geoflowslam_tpu_torch.pipeline import of_tracking as TOF
from geoflowslam_tpu_torch.state.frame import build_frame as t_build_frame

torch.set_num_threads(2)

W, H, FX = 320, 240, 200.0
N_OF = 256
CPU = torch.device("cpu")


def _two_views(seed=1, n=300):
    """Points seen from two poses, 0.3 px noise, 40 gross outliers, ~10%
    invalid."""
    rs = np.random.RandomState(seed)
    x = np.c_[rs.rand(n) * 4 - 2, rs.rand(n) * 3 - 1.5, rs.rand(n) * 3 + 2]
    th = 0.1
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]])

    def proj(p):
        return (p[:, :2] / p[:, 2:] * 200 + [160, 120]).astype(np.float32)

    uv1 = proj(x)
    uv2 = proj(x @ rot.T + [0.2, 0.05, 0.0])
    uv2 += rs.randn(n, 2).astype(np.float32) * 0.3
    uv2[:40] += rs.randn(40, 2).astype(np.float32) * 20
    return uv1, uv2, rs.rand(n) > 0.1


def test_ransac_fundamental_matches_reference_on_same_sets():
    uv1, uv2, valid = _two_views()
    key = jax.random.PRNGKey(3)
    sets = np.array(JR._sample_minimal_sets(key, jnp.asarray(valid), 64, 8))
    rj = JR.ransac_fundamental(key, jnp.asarray(uv1), jnp.asarray(uv2),
                               jnp.asarray(valid), n_hyp=64)
    rt = TR.ransac_fundamental(None, torch.from_numpy(uv1),
                               torch.from_numpy(uv2), torch.from_numpy(valid),
                               n_hyp=64,
                               sample_sets=torch.from_numpy(sets).long())
    assert np.array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    assert int(rt.n_inliers) == int(rj.n_inliers) > 200
    score = float(rj.score)
    assert abs(float(rt.score) - score) <= 1e-4 * abs(score)
    fj, ft = np.asarray(rj.model), rt.model.numpy()
    fj, ft = fj / np.linalg.norm(fj), ft / np.linalg.norm(ft)
    assert min(np.abs(fj - ft).max(), np.abs(fj + ft).max()) < 1e-3


def test_minimal_sets_from_gumbel_noise_and_generator():
    _, _, valid = _two_views()
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.gumbel(key, (64, len(valid))))
    want = np.asarray(JR._sample_minimal_sets(key, jnp.asarray(valid), 64, 8))
    got = TR._sample_minimal_sets(None, torch.from_numpy(valid), 64, 8,
                                  noise=torch.from_numpy(noise))
    assert np.array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(0)
    sets = TR._sample_minimal_sets(gen, torch.from_numpy(valid), 64, 8).numpy()
    assert valid[sets].all()
    assert all(len(set(row)) == 8 for row in sets)


@pytest.fixture(scope="module")
def of_inputs():
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              n_of_slots=N_OF)
    sc = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=20.0)
    jcfg = JSys(frame=JFrame(orb=JOrb(**orb), **fc), **sc)
    tcfg = C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(**orb), **fc),
                          **sc)
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=5.0)
    jbf = jax.jit(lambda g, d: j_build_frame(g, d, jcfg.frame, FX, FX,
                                             W / 2, H / 2))
    frames, poses = [], []
    for t in (0.0, 0.4):
        g, d, (r, tc) = seq.frame(t)
        frames.append(jbf(jnp.asarray(g), jnp.asarray(d)))
        poses.append((np.asarray(r, np.float64), np.asarray(tc, np.float64)))
        if t == 0.0:
            port_frame0 = t_build_frame(
                torch.from_numpy(np.array(g)), torch.from_numpy(np.array(d)),
                tcfg.frame, FX, FX, W / 2, H / 2)
    ms = JM.create(24, 300 + N_OF, 4096)
    ms, _, res = JT.stereo_initialization(ms, frames[0], jnp.float32(0.0),
                                          jcfg.track_cfg())
    (r0, t0), (r1, t1) = poses
    pr = (r1 @ r0.T).astype(np.float32)
    pt = (t1 - r1 @ r0.T @ t0).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    n = 300 + N_OF
    noise = (np.array(jax.random.gumbel(k1, (64, n))),
             np.array(jax.random.gumbel(k2, (64, n))))
    obs = np.array(res.obs_mp)
    obs[::2] = -1
    jout = JOF.of_dual_stream(ms, frames[0], frames[1], jnp.asarray(obs),
                              jnp.asarray(pr), jnp.asarray(pt), key,
                              jcfg.track_cfg(), JOF.OFConfig(), N_OF)
    tout = TOF.of_dual_stream(
        convert.map_state(ms, CPU), convert.frame_data(frames[0], CPU),
        convert.frame_data(frames[1], CPU),
        torch.from_numpy(obs), torch.from_numpy(pr),
        torch.from_numpy(pt), None, tcfg.track_cfg(), TOF.OFConfig(), N_OF,
        gumbel=tuple(torch.from_numpy(x) for x in noise))
    return jout, tout, frames[0], port_frame0


def test_build_frame_reserves_of_slots_like_reference(of_inputs):
    """The port's frame ends in N_OF empty slots without depth and keeps the
    metric depth image, as the reference's does."""
    _, _, jf, tf = of_inputs
    assert tf.feat.capacity == 300 + N_OF
    sl = slice(300, None)
    assert not tf.feat.valid[sl].any() and (tf.depth_kp[sl] == -1).all()
    assert (tf.u_right[sl] == -1).all() and (tf.feat.uv[sl] == 0).all()
    assert (tf.feat.desc[sl] == 0).all() and (tf.feat.level[sl] == 0).all()
    np.testing.assert_array_equal(tf.depth_img.numpy(),
                                  np.asarray(jf.depth_img))
    for name in ("valid", "level"):
        np.testing.assert_array_equal(getattr(tf.feat, name).numpy()[sl],
                                      np.asarray(getattr(jf.feat, name))[sl])


def test_of_config_equals_reference():
    assert JOF.OFConfig().__dict__ == TOF.OFConfig().__dict__


def test_of_dual_stream_matches_reference(of_inputs):
    (jf, jobs, jn3, jn2, jinn), (tf, tobs, tn3, tn2, tinn) = of_inputs[:2]
    n3j, n2j, n3t, n2t = int(jn3), int(jn2), int(tn3), int(tn2)
    assert n3j > 5 and n2j > 3
    assert abs(n3t - n3j) <= 2 and abs(n2t - n2j) <= 2
    sl = slice(300, 300 + N_OF)
    jobs, tobs = np.asarray(jobs), tobs.numpy()
    assert (jobs[:300] == -1).all() and (tobs[:300] == -1).all()
    jv, tv = np.asarray(jf.feat.valid)[sl], tf.feat.valid.numpy()[sl]
    assert jv.sum() == n3j + n2j and tv.sum() == n3t + n2t
    # the base keypoints are untouched
    assert np.array_equal(tf.feat.uv.numpy()[:300],
                          np.asarray(jf.feat.uv)[:300])

    # 3D-stream slots, matched by map-point binding
    jmp = {int(m): i for i, m in enumerate(jobs[sl]) if m >= 0}
    tmp = {int(m): i for i, m in enumerate(tobs[sl]) if m >= 0}
    common = set(jmp) & set(tmp)
    assert len(set(jmp) ^ set(tmp)) <= 2 and len(common) >= n3j - 2
    ji = np.array([jmp[m] for m in sorted(common)]) + 300
    ti = np.array([tmp[m] for m in sorted(common)]) + 300
    np.testing.assert_allclose(tf.feat.uv.numpy()[ti],
                               np.asarray(jf.feat.uv)[ji], atol=1e-3)
    np.testing.assert_allclose(tf.depth_kp.numpy()[ti],
                               np.asarray(jf.depth_kp)[ji], atol=1e-4)
    np.testing.assert_allclose(tf.u_right.numpy()[ti],
                               np.asarray(jf.u_right)[ji], atol=1e-2)
    assert np.array_equal(tf.feat.desc.numpy()[ti],
                          np.asarray(jf.feat.desc).view(np.int32)[ji])
    np.testing.assert_allclose(tinn.numpy()[ti], np.asarray(jinn)[ji],
                               atol=1e-3)
    assert (tf.depth_kp.numpy()[ti] > 0).mean() > 0.9

    # 2D-stream slots: valid, unbound; each finds a reference slot
    j2 = np.asarray(jf.feat.uv)[sl][jv & (jobs[sl] < 0)]
    t2 = tf.feat.uv.numpy()[sl][tv & (tobs[sl] < 0)]
    if len(t2):
        d = np.linalg.norm(t2[:, None] - j2[None], axis=2).min(axis=1)
        assert (d > 1e-3).sum() <= 2
    assert (tinn.numpy()[sl][tv & (tobs[sl] < 0)] == 1e9).all()
