"""Port parity of the relocalization and loop-closing geometry against the
JAX package, on inputs made with numpy from a seed:

* Sim3 exp/compose/inverse/apply and se3_log within 1e-5;
* gms_filter exact;
* ransac_pnp, refine_pnp_ml, solve_sim3_horn and ransac_sim3 with the same
  minimal sets on both sides (drawn by jax.random and handed over): the
  same inlier set, models within 1e-4;
* optimize_pose_graph (SE3, Sim3 and yaw-only) and optimize_sim3_pair
  within 1e-4;
* merge_maps: ids and masks exact, poses and points within 1e-6 (3-term
  dot products summed in another order may differ in the last bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.ops import gms as JG
from geoflowslam_tpu.ops import ransac as JR
from geoflowslam_tpu.solvers import pose_graph as JPG
from geoflowslam_tpu.state import map_state as JMS

from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.math import lie as TL
from geoflowslam_tpu_torch.ops import gms as TG
from geoflowslam_tpu_torch.ops import ransac as TR
from geoflowslam_tpu_torch.solvers import pose_graph as TPG
from geoflowslam_tpu_torch.state import map_state as TMS

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _rot(rs, scale):
    return np.asarray(JL.so3_exp(jnp.asarray(rs.randn(3) * scale,
                                             jnp.float32)))


@pytest.mark.parametrize("scale", [1e-9, 1e-3, 0.4, 1.5])
def test_sim3_and_se3_log(scale):
    """Within 1e-5, relative where the values exceed 1 (at scale 1.5 the
    scale factor reaches e^4 and float32 results reach ~10)."""
    rs = np.random.RandomState(int(scale * 1e3) + 1)
    xi = (rs.randn(16, 7) * scale).astype(np.float32)
    xi[:4, 6] = 0.0                                  # sigma exactly 0
    xi[4:8, 3:6] = 0.0                               # theta exactly 0
    js = JL.sim3_exp(jnp.asarray(xi))
    ts = TL.sim3_exp(_t(xi))
    for a, b in zip(js, ts):
        _close(a, b, 1e-5, 1e-5)
    jc = JL.sim3_compose(*js, *(x[::-1] for x in js))
    tc = TL.sim3_compose(*ts, *(x.flip(0) for x in ts))
    for a, b in zip(jc, tc):
        _close(a, b, 1e-5, 1e-5)
    for a, b in zip(JL.sim3_inverse(*js), TL.sim3_inverse(*ts)):
        _close(a, b, 1e-5, 1e-5)
    pts = rs.randn(16, 5, 3).astype(np.float32)
    _close(JL.sim3_apply(*js, jnp.asarray(pts)), TL.sim3_apply(*ts, _t(pts)),
           1e-5, 1e-5)
    rot, t = JL.se3_exp(jnp.asarray(xi[:, :6]))
    _close(JL.se3_log(rot, t), TL.se3_log(_t(rot), _t(t)), 1e-5, 1e-5)


def test_gms_filter_exact():
    rs = np.random.RandomState(0)
    n, m, w, h = 600, 500, 320, 240
    uv_a = (rs.rand(n, 2) * [w, h]).astype(np.float32)
    uv_b = (rs.rand(m, 2) * [w, h]).astype(np.float32)
    match = np.full(n, -1, np.int32)
    inl = rs.rand(n) < 0.5
    tgt = rs.choice(m, n)
    # half the matches follow one motion, the rest are random
    uv_b[tgt[inl]] = np.clip(uv_a[inl] + [12.0, -7.0]
                             + rs.randn(inl.sum(), 2) * 2, 0, [w - 1, h - 1])
    keep = rs.rand(n) < 0.9
    match[keep] = tgt[keep]
    want = np.asarray(JG.gms_filter(jnp.asarray(uv_a), jnp.asarray(uv_b),
                                    jnp.asarray(match), (w, h), (w, h)))
    got = TG.gms_filter(_t(uv_a), _t(uv_b), _t(match), (w, h), (w, h))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want >= 0).sum() < keep.sum()


def _pnp_problem(seed, n=200, outlier=0.3):
    rs = np.random.RandomState(seed)
    pts = (rs.randn(n, 3) * [1.0, 0.7, 0.5] + [0, 0, 3.0]).astype(np.float32)
    rot = _rot(rs, 0.1)
    t = (rs.randn(3) * 0.2).astype(np.float32)
    pc = pts @ rot.T + t
    uvn = pc[:, :2] / pc[:, 2:3] + rs.randn(n, 2) * 0.002
    bad = rs.rand(n) < outlier
    uvn[bad] = rs.uniform(-0.6, 0.6, (bad.sum(), 2))
    valid = rs.rand(n) > 0.05
    return pts, uvn.astype(np.float32), valid, rot, t


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_and_ml_refinement(seed):
    pts, uvn, valid, _, _ = _pnp_problem(seed)
    key = jax.random.PRNGKey(seed)
    sets = np.asarray(JR._sample_minimal_sets(key, jnp.asarray(valid), 128, 6))
    jr = JR.ransac_pnp(key, jnp.asarray(pts), jnp.asarray(uvn),
                       jnp.asarray(valid), threshold_px=5.99, focal=200.0)
    tr = TR.ransac_pnp(None, _t(pts), _t(uvn), _t(valid), threshold_px=5.99,
                       focal=200.0, sample_sets=_t(sets).long())
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    _close(jr.model, tr.model, 1e-4)
    jm = JR.refine_pnp_ml(jr.model[:, :3], jr.model[:, 3], jnp.asarray(pts),
                          jnp.asarray(uvn), jr.inliers)
    tm = TR.refine_pnp_ml(tr.model[:, :3], tr.model[:, 3], _t(pts), _t(uvn),
                          tr.inliers)
    for a, b in zip(jm, tm):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_horn_and_ransac(fix_scale):
    rs = np.random.RandomState(3 + fix_scale)
    n = 150
    p1 = (rs.randn(n, 3) + [0, 0, 3]).astype(np.float32)
    s = 1.0 if fix_scale else 1.3
    rot = _rot(rs, 0.3)
    t = (rs.randn(3) * 0.5).astype(np.float32)
    p2 = (s * p1 @ rot.T + t + rs.randn(n, 3) * 0.01).astype(np.float32)
    bad = rs.rand(n) < 0.3
    p2[bad] += rs.randn(bad.sum(), 3).astype(np.float32)
    valid = rs.rand(n) > 0.05
    w = rs.rand(n).astype(np.float32)
    for a, b in zip(JR.solve_sim3_horn(jnp.asarray(p1), jnp.asarray(p2),
                                       jnp.asarray(w), fix_scale=fix_scale),
                    TR.solve_sim3_horn(_t(p1), _t(p2), _t(w),
                                       fix_scale=fix_scale)):
        _close(a, b, 1e-4)
    key = jax.random.PRNGKey(7)
    sets = np.asarray(JR._sample_minimal_sets(key, jnp.asarray(valid), 64, 3))
    jr = JR.ransac_sim3(key, jnp.asarray(p1), jnp.asarray(p2),
                        jnp.asarray(valid), fix_scale=fix_scale,
                        threshold=0.1)
    tr = TR.ransac_sim3(None, _t(p1), _t(p2), _t(valid), fix_scale=fix_scale,
                        threshold=0.1, sample_sets=_t(sets).long())
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    _close(jr.model, tr.model, 1e-4)
    js = JPG.optimize_sim3_pair(jr.model[0], jr.model[1:10].reshape(3, 3),
                                jr.model[10:13], jnp.asarray(p1),
                                jnp.asarray(p2), jr.inliers,
                                fix_scale=fix_scale)
    ts = TPG.optimize_sim3_pair(tr.model[0], tr.model[1:10].reshape(3, 3),
                                tr.model[10:13], _t(p1), _t(p2), tr.inliers,
                                fix_scale=fix_scale)
    for a, b in zip(js[:3], ts[:3]):
        _close(a, b, 1e-4)
    np.testing.assert_array_equal(ts[3].numpy(), np.asarray(js[3]))


def _graph(seed, k=10, e=24):
    """A chain of k poses with covisibility-like edges measured from the
    true poses plus noise, the estimate drifted, and one loop edge."""
    rs = np.random.RandomState(seed)
    true_r = np.stack([_rot(rs, 0.2) for _ in range(k)])
    true_t = (rs.randn(k, 3) * 0.5).astype(np.float32)
    est_r = np.stack([r @ _rot(rs, 0.02 * i) for i, r in enumerate(true_r)])
    est_t = (true_t + rs.randn(k, 3) * 0.03 * np.arange(k)[:, None]
             ).astype(np.float32)
    ei = np.concatenate([np.arange(k - 1), rs.randint(0, k, e - k + 1)])
    ej = np.concatenate([np.arange(1, k), rs.randint(0, k, e - k + 1)])
    ei[-1], ej[-1] = 0, k - 1                       # the loop edge
    r_rel = np.einsum("eab,ecb->eac", true_r[ei], true_r[ej])
    t_rel = true_t[ei] - np.einsum("eab,eb->ea", r_rel, true_t[ej])
    s_rel = np.ones(e, np.float32)
    s_rel[-1] = 1.02
    w = rs.rand(e).astype(np.float32) + 0.1
    w[-1] = 5.0
    valid = rs.rand(e) > 0.1
    valid[-1] = True
    edges = dict(i=ei.astype(np.int32), j=ej.astype(np.int32), s=s_rel,
                 rot=r_rel.astype(np.float32), t=t_rel.astype(np.float32),
                 weight=w, valid=valid)
    kf_valid = np.ones(k, bool)
    kf_valid[3] = False
    fixed = np.zeros(k, bool)
    fixed[0] = True
    return est_r.astype(np.float32), est_t, kf_valid, fixed, edges


@pytest.mark.parametrize("fix_scale,yaw_only", [(True, False), (False, False),
                                                (True, True)])
def test_optimize_pose_graph(fix_scale, yaw_only):
    est_r, est_t, kf_valid, fixed, e = _graph(5 + 2 * fix_scale + yaw_only)
    k = est_r.shape[0]
    je = JPG.PoseGraphEdges(**{f: jnp.asarray(v) for f, v in e.items()})
    te = TPG.PoseGraphEdges(**{f: _t(v) for f, v in e.items()})
    jo = JPG.optimize_pose_graph(jnp.ones(k), jnp.asarray(est_r),
                                 jnp.asarray(est_t), jnp.asarray(kf_valid),
                                 jnp.asarray(fixed), je, fix_scale=fix_scale,
                                 iters=10, yaw_only=yaw_only)
    to = TPG.optimize_pose_graph(torch.ones(k), _t(est_r), _t(est_t),
                                 _t(kf_valid), _t(fixed), te,
                                 fix_scale=fix_scale, iters=10,
                                 yaw_only=yaw_only)
    for a, b in zip(jo, to):
        _close(a, b, 1e-4)
    assert np.abs(np.asarray(jo[2]) - est_t).max() > 1e-3   # it moved


def test_merge_maps():
    rs = np.random.RandomState(9)
    k, n, m = 8, 16, 64
    ms = JMS.create(k, n, m)
    ms = ms._replace(
        kf_rot=jnp.asarray(np.stack([_rot(rs, 0.5) for _ in range(k)])),
        kf_t=jnp.asarray(rs.randn(k, 3).astype(np.float32)),
        kf_valid=jnp.asarray(rs.rand(k) > 0.2),
        kf_map_id=jnp.asarray(rs.randint(0, 3, k).astype(np.int32)),
        mp_pos=jnp.asarray(rs.randn(m, 3).astype(np.float32)),
        mp_valid=jnp.asarray(rs.rand(m) > 0.2),
        mp_map_id=jnp.asarray(rs.randint(0, 3, m).astype(np.int32)),
        active_map=jnp.int32(2), n_maps=jnp.int32(3))
    s, rot = jnp.float32(1.1), jnp.asarray(_rot(rs, 0.4))
    t = jnp.asarray(rs.randn(3).astype(np.float32))
    want = JMS.merge_maps(ms, jnp.int32(2), jnp.int32(0), s, rot, t)
    got = TMS.merge_maps(convert.map_state(ms, "cpu"), 2, 0, _t(s),
                         _t(rot), _t(t))
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if a.dtype.kind == "f":
            _close(a, b, 1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
